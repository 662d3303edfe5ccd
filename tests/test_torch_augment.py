"""The port's window warping against the JAX package's
(``deepards_tpu/data/augment.py``): the same flow-like batch and the same
seeded generator through each transform give the same windows bit for
bit, and leave the generator in the same state."""
import numpy as np
import pytest

from deepards_tpu.data import augment as jaug
from deepards_tpu_torch.data import augment


def _batch(seed, b=3, s=6, length=224):
    """(b, s, 1, L) flow-like windows: a half-sine inspiration and an
    exponential expiration, random period, amplitude and phase, noise;
    one window of inspiration only (no x0)."""
    rng = np.random.default_rng(seed)
    t = np.arange(length) * 0.02
    period = rng.uniform(2.5, 4.0, size=(b, s, 1, 1))
    amp = rng.uniform(30.0, 60.0, size=(b, s, 1, 1))
    phase = (t / period + rng.uniform(0, 1, size=(b, s, 1, 1))) % 1.0
    flow = np.where(phase < 0.35, amp * np.sin(np.pi * phase / 0.35),
                    -0.8 * amp * np.exp(-8.0 * (phase - 0.35)))
    flow += rng.normal(scale=1.0, size=flow.shape)
    flow[0, 0, 0] = np.abs(flow[0, 0, 0]) + 1.0  # never crosses zero
    return flow.astype(np.float32)


_CONFIGS = {
    "ie_ww": (["ie_ww"], 1.0, False),
    "naive_ww": (["naive_ww"], 1.0, False),
    "ie_ww_i_or_e-i": (["ie_ww_i_or_e"], 1.0, True),
    "ie_ww_i_or_e-e": ("ie_ww_i_or_e", 1.0, False),
    "all-p0.5": (["ie_ww", "naive_ww", "ie_ww_i_or_e"], 0.5, False),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name", sorted(_CONFIGS))
def test_warps_equal_jax(name, seed):
    names, prob, use_i = _CONFIGS[name]
    data = _batch(seed)
    want_rng = np.random.default_rng(seed + 10)
    got_rng = np.random.default_rng(seed + 10)
    want = jaug.apply_to_batch(jaug.build_transforms(names, prob, use_i),
                               data, want_rng)
    got = augment.apply_to_batch(augment.build_transforms(names, prob, use_i),
                                 data, got_rng)
    assert got.dtype == want.dtype and got.shape == data.shape
    np.testing.assert_array_equal(got, want)
    assert got_rng.bit_generator.state == want_rng.bit_generator.state
    if prob == 1.0:
        assert not np.array_equal(got, data)  # every window was warped


def test_build_transforms_takes_a_bare_name():
    """A yml's ``transforms: ie_ww_i_or_e`` is one name, not a substring
    test that would also pick ``ie_ww``."""
    composed = augment.build_transforms("ie_ww_i_or_e", 0.2)
    assert [type(t).__name__ for t in composed.transforms] == [
        "IEWindowWarpingIEProgrammable"]


@pytest.mark.parametrize("cls", ["NaiveWindowWarping", "IEWindowWarping"])
def test_probability_out_of_range_raises(cls):
    with pytest.raises(ValueError):
        getattr(augment, cls)(0.5, 2, 1.5)
