"""``cnn_linear``: a sample is a window of S breaths; their S x 128
features, flattened, go through one Linear of S*128 -> 2."""
import torch.nn.functional as F

from benchmark.reference import model

STEP = "samples"


def param_spec(n_sub_batches, in_channels=1):
    return model.backbone_spec(in_channels) + model.dense_spec(
        "head", 2, n_sub_batches * model.n_features())


def logits(p, feats, quant=None):
    """(B, S, F) -> (B, 2)."""
    q = quant or model.identity
    return q(F.linear(feats.reshape(feats.shape[0], -1), q(p["head.weight"]),
                      q(p["head.bias"])))
