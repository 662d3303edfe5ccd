"""Generate the experiment-file registry.

Counterpart of ``deepards_tpu/config/generate_experiments.py``, with its
own copy of the registry's dicts: ``reference_experiments()`` (the 215
reference experiment names, reference: deepards/experiment_files/*.yml),
``extra_experiments()`` (the benchmark configs and the detection and FFT
variants) and ``experiments()``, both merged.  ``write_all(out_dir)``
writes each as the JAX generator does (``yaml.safe_dump(...,
default_flow_style=False, sort_keys=True)``, byte for byte, through
``config.yamlfile``; no PyYAML).  The port commits no copy of the 228
files: its tools write the registry where they need it.

A few reference files carry fossil keys (``pochs``, ``butter_freq``,
``overample_all_factor``): both config systems carry unknown keys as
attributes nobody reads, so these are reproduced verbatim.

    python -m deepards_tpu_torch.config.generate_experiments OUT_DIR
"""
import argparse
import os

from deepards_tpu_torch.config import yamlfile

# the common kfold experiment base (the de-facto default preamble of the
# reference's kfold ymls)
KFOLD = {
    "batch_size": 16,
    "clip_grad": True,
    "clip_val": 0.01,
    "dataset_type": "unpadded_centered_sequences",
    "epochs": 10,
    "kfolds": 5,
    "n_sub_batches": 20,
    "network": "cnn_linear",
    "oversample_minority": True,
}

# the heterogeneity/holdout experiment base (no kfolds; main holdout dirs)
HOLDOUT = {
    "base_network": "densenet18",
    "batch_size": 16,
    "clip_val": 0.01,
    "dataset_type": "unpadded_centered_sequences",
    "epochs": 5,
    "holdout_set_type": "main",
    "n_sub_batches": 20,
    "network": "cnn_linear",
}


def _merge(base, **kw):
    out = dict(base)
    out.update(kw)
    return out


def reference_experiments():
    """name -> config for all 215 reference experiment files
    (reference: deepards/experiment_files/*.yml)."""
    exps = {}
    K, H = KFOLD, HOLDOUT  # noqa: N806

    # -- headline kfold baselines -----------------------------------------
    exps["unpadded_centered_nb20_cnn_linear"] = _merge(K, random_kfold=False)
    exps["unpadded_centered_nb20_cnn_linear_random_kfold"] = _merge(
        K, random_kfold=True)
    exps["unpadded_centered_nb20_cnn_linear_bootstrap"] = _merge(
        K, kfolds=1, bootstrap=True, random_kfold=False)
    exps["unpadded_centered_20_len_sub_batch_cnn"] = dict(K)
    exps["unpadded_centered_20_len_sub_batch_cnn_lstm"] = _merge(
        K, network="cnn_lstm")
    exps["unpadded_20_len_sub_batch_cnn"] = _merge(
        K, dataset_type="unpadded_sequences")
    exps["unpadded_centered_100_len_sub_batch"] = _merge(
        K, n_sub_batches=100,
        experiment_name="unpadded_centered_100_sub_batches")
    exps["unpadded_centered_100_len_sub_batch_cnn"] = (
        exps["unpadded_centered_100_len_sub_batch"])
    exps["downsampled_20_len_sub_batch_cnn"] = _merge(
        K, dataset_type="unpadded_downsampled_sequences")
    exps["downsampled_20_len_sub_batch_cnn_e30"] = _merge(
        K, dataset_type="unpadded_downsampled_sequences", epochs=30)
    exps["unpadded_centered_with_bm"] = _merge(
        K, dataset_type="unpadded_centered_with_bm")
    exps["unpadded_centered_cnn_linear_rf_compr"] = _merge(
        K, dataset_type="unpadded_centered_with_bm",
        network="cnn_linear_compr_to_rf")
    exps["unpadded_centered_cnn_to_mean"] = _merge(
        K, dataset_type="unpadded_centered_with_bm",
        network="cnn_linear_to_mean")
    exps["aim1_70_30_holdout"] = _merge(
        H, epochs=10, bootstrap=False, random_kfold=False)

    # -- padded-breath family ----------------------------------------------
    padded = _merge(K, dataset_type="padded_breath_by_breath")
    exps["padded_bbb_20_len_sub_batch_cnn_lstm"] = _merge(
        padded, network="cnn_lstm")
    exps["padded_breath_by_breath"] = _merge(
        padded, network="lstm_only", n_sub_batches=100)
    exps["padded_breath_by_breath_cnn"] = _merge(
        padded, n_sub_batches=100, experiment_name="padded_bbb_cnn_linear")
    exps["padded_breath_by_breath_cnn_nb_20"] = _merge(
        padded, experiment_name="padded_bbb_cnn_linear_nb_20")

    # -- post-hoc downsampling grid (padded_..._downsamp_*x.yml) -----------
    for f in (1.2, 1.4, 1.6, 1.8, 2.0, 2.5, 3.0, 3.5, 4.0,
              6.0, 8.0, 10.0, 15.0, 20.0, 25.0):
        exps["padded_breath_by_breath_cnn_linear_downsamp_{}x".format(f)] = (
            _merge(padded, post_hoc_downsampling=f, random_kfold=False)
        )

    # -- lstm family ---------------------------------------------------------
    exps["lstm_double"] = _merge(K, network="double_lstm")
    exps["lstm_only_experiment_benchmark"] = _merge(K, network="lstm_only")
    lstm_packing = _merge(padded, network="lstm_only_with_packing",
                          pochs=10)  # 'pochs' fossil: epochs falls to default
    del lstm_packing["epochs"]
    exps["lstm_only_with_packing"] = lstm_packing

    # -- window-warping augmentation families --------------------------------
    exps["naive_window_warping"] = _merge(
        K, network="lstm_only", transforms="naive_ww")
    exps["window_warping"] = _merge(
        K, network="lstm_only", transforms="ie_ww")
    for net, tag in (("cnn_linear", "cnn"), ("lstm_only", "lstm")):
        exps["ie_window_warping_50_prob_{}".format(tag)] = _merge(
            K, network=net, transforms="ie_ww", transform_probability=0.5)
        for use_i, limb in ((True, "i"), (False, "e")):
            exps["ie_window_warping_50_prob_{}_only_{}".format(
                limb, tag)] = _merge(
                K, network=net, transforms="ie_ww_i_or_e",
                transform_probability=0.5, use_i=use_i)
    ww15 = _merge(K, transforms="ie_ww", transform_probability=0.5,
                  oversample_all_factor=1.5)
    for fossil in ("clip_grad", "clip_val"):  # this one file lacks clip keys
        del ww15[fossil]
    exps["unpadded_centered_nb20_cnn_linear_ie_window_warping_"
         "oversamp_all_1.5"] = ww15
    for over in (2.0, 3.0):
        exps["unpadded_centered_nb20_cnn_linear_ie_window_warping_"
             "oversamp_all_{}".format(over)] = _merge(
            K, transforms="ie_ww", transform_probability=0.5,
            oversample_all_factor=over)
    exps["unpadded_centered_nb20_cnn_linear_e_window_warping_"
         "oversamp_all_2.0"] = _merge(
        K, transforms="ie_ww_i_or_e", transform_probability=0.5,
        oversample_all_factor=2.0)

    # -- I/E-limb drop / expiratory truncation ------------------------------
    for limb in ("i", "e"):
        exps["drop_{}_lim".format(limb)] = _merge(
            K, drop_i_lim=(limb == "i"), drop_e_lim=(limb == "e"),
            experiment_name="drop_{}_lim_unpadded".format(limb))
    exps["drop_e_lim_e20"] = _merge(exps["drop_e_lim"], epochs=20)
    for lim, tag in ((0.24, "24"), (0.5, "50"), (0.74, "74"), (1.0, "100")):
        conf = _merge(K, drop_i_lim=False, drop_e_lim=False,
                      truncate_e_lim=lim,
                      experiment_name="truncate_e_lim_{}".format(tag))
        exps["truncate_e_lim{}".format(tag)] = conf
        exps["truncate_e_lim{}_e20".format(tag)] = _merge(conf, epochs=20)

    # -- DTW-driven under/oversampling grids --------------------------------
    exps["unpadded_centered_20_len_sub_batch_cnn_undersample05"] = _merge(
        K, oversample_minority=False, undersample_factor=0.05)
    exps["unpadded_centered_20_len_sub_batch_cnn_undersample5"] = _merge(
        K, oversample_minority=False, undersample_factor=0.5)
    for uf, tag in ((0.1, "1"), (0.25, "25")):
        exps["unpadded_centered_20_len_sub_batch_cnn_undersample{}".format(
            tag)] = _merge(K, oversample_minority=False,
                           undersample_factor=uf)
        for std in (0.2, 0.3, 0.4, 0.5):
            exps["unpadded_centered_20_len_sub_batch_cnn_undersample"
                 "{}_std{}".format(tag, str(std)[-1])] = _merge(
                K, oversample_minority=False, undersample_factor=uf,
                undersample_std_factor=std)
    # one fossil: undersample1_std2 kept oversample_minority on
    exps["unpadded_centered_20_len_sub_batch_cnn_undersample1_std2"][
        "oversample_minority"] = True
    for std in (0.1, 0.2, 0.3):
        exps["unpadded_centered_20_len_sub_batch_cnn_oversample_"
             "undersample1_std{}".format(str(std)[-1])] = _merge(
            K, undersample_factor=0.1, undersample_std_factor=std)

    # -- fractional training patients (train_frac*.yml; no epochs key) ------
    frac_base = {k: v for k, v in H.items()
                 if k not in ("epochs", "holdout_set_type")}
    for tag, frac in (("025", 0.025), ("05", 0.05), ("075", 0.075),
                      ("1", 0.1), ("125", 0.125), ("25", 0.25),
                      ("50", 0.5), ("75", 0.75)):
        exps["train_frac{}".format(tag)] = _merge(
            frac_base, kfolds=5, train_pt_frac=frac)

    # -- heterogeneity / DTW holdout studies ---------------------------------
    exps["heterogeneity"] = dict(H)
    exps["heterogeneity_random"] = _merge(H, holdout_set_type="random")
    exps["heterogeneity_80_20_random"] = _merge(
        H, holdout_set_type="80_20_random", final_validation=True)
    exps["heterogeneity_kfold"] = _merge(
        H, holdout_set_type="random", kfolds=5, epochs=10)
    for pct in range(10, 100, 10):
        exps["heterogeneity_filter_by_train_{}".format(pct)] = _merge(
            H, holdout_set_type="random", drop_if_under_r2=pct / 100.0)
    exps["heterogeneity_fix_i_only_ww"] = _merge(
        K, epochs=5, transforms="ie_ww_i_or_e", transform_probability=0.5,
        use_i=True)

    # -- similarity/dissimilarity split holdouts ------------------------------
    sim_base = _merge({k: v for k, v in H.items()
                       if k != "holdout_set_type"}, final_validation=True)
    for kind in ("similarity", "dissimilarity"):
        exps["holdout_with_{}_split".format(kind)] = _merge(
            sim_base, epochs=15,
            holdout_set_type="fold_0_{}_split".format(kind))
        for fold in (1, 2, 3, 4):
            exps["holdout_with_{}_split_fold{}".format(kind, fold)] = _merge(
                sim_base, epochs=20,
                holdout_set_type="fold_{}_{}_split".format(fold, kind))
    for i in range(1, 10):
        exps["train_sim_test_sim_dissim_split_{}".format(i)] = _merge(
            sim_base, epochs=15,
            holdout_set_type="train_sim_test_sim_dissim_split_{}".format(i))
    exps["train_similar_test_sim_and_dissim"] = _merge(
        sim_base, epochs=15, holdout_set_type="train_sim_test_sim_dissim")

    # -- butterworth band studies --------------------------------------------
    rk = _merge(K, random_kfold=False)
    lows = (0.03125, 0.0625, 0.125, 0.25, 0.5,
            2, 4, 6, 8, 10, 15, 20, 21, 22, 23, 24)
    for lo in lows:
        tag = (str(lo).replace("0.", "dot") if lo < 1 else str(lo))
        exps["unpadded_centered_nb20_cnn_linear_butter_{}hz".format(tag)] = (
            _merge(rk, butter_low=lo)
        )
    exps["unpadded_centered_nb20_cnn_linear_butter_1hz"] = _merge(
        rk, butter_freq=1)  # fossil key: predates butter_low/high
    exps["unpadded_centered_nb20_cnn_linear_butter_0_dot25hz_sanity"] = (
        _merge(rk, butter_low=1e-08, butter_high=0.25)
    )
    for lo, hi in ((1, 2), (2, 3), (3, 4), (4, 5), (5, 10), (10, 15),
                   (15, 20)):
        exps["unpadded_centered_nb20_cnn_linear_butter_{}_{}hz".format(
            lo, hi)] = _merge(rk, butter_low=lo, butter_high=hi)
    # two fossils: the "0_5" name only sets a highpass low, "20_25" only a
    # lowpass high
    exps["unpadded_centered_nb20_cnn_linear_butter_0_5hz"] = _merge(
        rk, butter_low=5)
    exps["unpadded_centered_nb20_cnn_linear_butter_20_25hz"] = _merge(
        rk, butter_high=20)
    padded_rk = _merge(rk, dataset_type="padded_breath_by_breath")
    exps["padded_breath_by_breath_cnn_linear_butter_0_5hz"] = _merge(
        padded_rk, butter_low=5)
    for lo, hi in ((5, 10), (10, 15), (15, 20), (20, 25)):
        exps["padded_breath_by_breath_cnn_linear_butter_{}_{}hz".format(
            lo, hi)] = _merge(padded_rk, butter_low=lo, butter_high=hi)

    # -- FFT band filtering ----------------------------------------------------
    for hi in (0.25, 0.5, 1, 2, 4, 6, 8, 10, 15, 20):
        tag = str(hi).replace("0.", "dot")
        exps["unpadded_centered_nb20_cnn_linear_fft_filter_0_{}hz".format(
            tag)] = _merge(rk, fft_filtering_low=0, fft_filtering_high=hi)

    # -- FFT input channels ------------------------------------------------------
    exps["unpadded_centered_nb20_cnn_linear_with_fft"] = _merge(
        K, with_fft=True)
    exps["unpadded_centered_nb20_cnn_linear_with_fft_real_only"] = _merge(
        K, with_fft=True, fft_real_only=True)
    exps["unpadded_centered_nb20_cnn_linear_only_fft"] = _merge(
        K, only_fft=True)
    exps["unpadded_centered_nb20_cnn_linear_only_fft_real_only"] = _merge(
        K, only_fft=True, fft_real_only=True)

    # -- 2D image path ----------------------------------------------------------
    d2 = _merge(K, network="cnn_linear_2d", batch_size=2)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2"] = dict(d2)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_baseline"] = dict(d2)
    for bs in (4, 8, 16):
        exps["unpadded_centered_nb20_cnn_linear_2d_bs{}".format(bs)] = (
            _merge(d2, batch_size=bs)
        )
    for kern in (5, 7, 9, 11):
        exps["unpadded_centered_nb20_cnn_linear_2d_bs2_{}_kern_"
             "baseline".format(kern)] = _merge(d2, block_kernel_size=kern)
        exps["unpadded_centered_nb20_cnn_linear_2d_bs2_{}_kern_fft_"
             "baseline".format(kern)] = _merge(
            d2, block_kernel_size=kern, with_fft=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_fft_baseline"] = _merge(
        d2, with_fft=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_add_fft_fft_real_"
         "only"] = _merge(d2, with_fft=True, fft_real_only=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_only_fft_baseline"] = (
        _merge(d2, only_fft=True)
    )
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_only_fft_fft_real_"
         "only"] = _merge(d2, only_fft=True, fft_real_only=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_focal_loss_baseline"] = (
        _merge(d2, loss="focal", fl_alpha=0.25, fl_gamma=2.0)
    )
    # 'overample_all_factor' fossil reproduced verbatim: the reference run
    # silently ignored the misspelled key, so this config == the baseline
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_oversamp_all_4.0_"
         "baseline"] = _merge(d2, overample_all_factor=4.0)
    for trans, tag in (("horiz_flip", "horiz_flip"), ("mag_warp", "mag_warp"),
                       ("rand_erase", "rand_erase"),
                       ("row_horiz_flip", "row_horiz_flip"),
                       ("row_shuffle", "row_shuff"), ("scale", "scale"),
                       ("time_warp", "time_warp"), ("win_slice", "win_slice"),
                       ("win_warp", "win_warp_by_img")):
        exps["unpadded_centered_nb20_cnn_linear_2d_bs2_{}".format(tag)] = (
            _merge(d2, two_dim_transforms=[trans])
        )
    for trans, tag in (("mag_warp", "mag_warp"), ("scale", "scale")):
        exps["unpadded_centered_nb20_cnn_linear_2d_bs2_{}_oversamp_all_"
             "4.0".format(tag)] = _merge(
            d2, two_dim_transforms=[trans], oversample_all_factor=4.0)
    row_mix = _merge(d2, row_mix=True, reload_dataset_per_epoch=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_row_mix_reload_per_"
         "epoch"] = row_mix
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_row_mix_reload_per_"
         "epoch_add_fft"] = _merge(row_mix, with_fft=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_row_mix_reload_per_"
         "epoch_add_fft_real"] = _merge(
        row_mix, with_fft=True, fft_real_only=True)
    exps["unpadded_centered_nb20_cnn_linear_2d_bs2_row_mix"] = _merge(
        d2, row_mix=True)
    d2x1 = _merge(d2, network="cnn_linear_2x1d")
    exps["unpadded_centered_nb20_cnn_linear_2x1d_bs2_baseline"] = dict(d2x1)
    exps["unpadded_centered_nb20_cnn_linear_2x1d_bs2_row_mix"] = _merge(
        d2x1, row_mix=True)
    exps["unpadded_centered_nb20_cnn_linear_2x1d_bs2_all_transforms"] = (
        _merge(d2x1, two_dim_transforms=[
            "win_slice", "win_warp", "row_shuffle", "horiz_flip"])
    )

    # -- detection (bbox-spliced images) --------------------------------------
    exps["unpadded_centered_nb20_retinanet_bs2_bbox_baseline"] = _merge(
        K, network="retinanet_2d", batch_size=2, epochs=20)
    exps["unpadded_centered_nb20_frcnn_bs2_bbox_baseline"] = _merge(
        K, network="faster_rcnn_2d", batch_size=2)

    # -- ProtoPNet -----------------------------------------------------------
    ppnet = _merge(K, dataset_type="unpadded_centered_with_bm",
                   network="protopnet")
    exps["protopnet_unpadded_centered"] = dict(ppnet)
    pp_np = _merge(ppnet, epochs=18, clust_lambda=0.8, sep_lambda=1.0,
                   push_start_epoch=6, push_every_n=4, n_push_iters=10,
                   viz_every_n=4)
    for n in range(1, 9):
        # fname-prefix fossil: np1 reused the np2 prefix in the reference
        prefix = "proto_kfold_np{}".format(2 if n == 1 else n)
        viz = 14 if n in (1, 2, 4) else 20
        conf = _merge(pp_np, n_prototypes=n, prototype_fname_prefix=prefix,
                      viz_start_epoch=viz)
        if n == 3:
            conf = _merge(conf, epochs=40, viz_start_epoch=100)
        exps["protopnet_unpadded_centered_np{}".format(n)] = conf
    exps["protopnet_final"] = _merge(
        pp_np, n_prototypes=4, prototype_fname_prefix="proto_kfold_np4",
        viz_start_epoch=14)
    exps["protopnet_unpadded_centered_np6_ww_i_only"] = _merge(
        pp_np, epochs=14, n_prototypes=6,
        prototype_fname_prefix="proto_kfold_np6_ww_i_only",
        viz_start_epoch=20, transforms="ie_ww_i_or_e",
        transform_probability=0.5, use_i=True, use_l1=True)
    pp_hold = _merge(
        {k: v for k, v in H.items()}, clip_grad=True,
        oversample_minority=True, network="protopnet", epochs=20,
        n_warm_epochs=4, clust_lambda=0.8, sep_lambda=1.0,
        push_start_epoch=8, push_every_n=4, viz_start_epoch=100)
    exps["protopnet_unpadded_centered_holdout"] = pp_hold
    exps["protopnet_unpadded_centered_holdout_transforms"] = _merge(
        pp_hold, viz_start_epoch=30, n_push_iters=5,
        prototype_fname_prefix="proto_holdout_transforms",
        transforms="ie_ww_i_or_e", transform_probability=0.5, use_i=True)
    exps["protopnet2d_unpadded_centered"] = _merge(
        K, network="protopnet_2d", n_prototypes=6,
        two_dim_transforms=["mag_warp", "row_shuffle", "win_warp"])

    # -- anonymized-cohort quickstart ---------------------------------------
    # cohort_file is machine-local in the reference yml (excluded from the
    # registry parity diff); the relative anonymized-cohort CSV name that
    # cli/anonymize_cohort.py writes is kept so the experiment works out of
    # the box
    exps["unpadded_centered_sequences_nb20_anon"] = {
        "base_network": "densenet18", "clip_val": 0.01,
        "cohort_file": "anon-desc.csv",
        "dataset_type": "unpadded_centered_sequences", "epochs": 10,
        "kfolds": 5, "n_sub_batches": 20, "network": "cnn_linear",
    }

    return exps


def extra_experiments():
    """Additions beyond the reference registry: the BASELINE.json
    benchmark configs and detection/2D variants the reference lacked."""
    exps = {}
    exps["bm_pretraining_regression"] = {
        "dataset_type": "padded_breath_by_breath_with_full_bm_target",
        "network": "cnn_regressor", "holdout_set_type": "main",
        "epochs": 10, "batch_size": 64, "n_sub_batches": 1,
        "optimizer": "adam", "learning_rate": 0.001,
    }
    exps["unpadded_centered_nb20_cnn_lstm"] = _merge(
        KFOLD, network="cnn_lstm", time_series_hidden_units=16)
    exps["padded_breath_by_breath_resnet18"] = _merge(
        KFOLD, dataset_type="padded_breath_by_breath",
        base_network="resnet18")
    exps["unpadded_centered_nb20_retinanet_2x1d_bs2_bbox_baseline"] = _merge(
        KFOLD, network="retinanet_2x1d", batch_size=2)
    # extra FFT band splits beyond the reference's 0..X lowpass studies
    for lo, hi in ((0, 5), (5, 10), (10, 15), (15, 20), (20, 25),
                   (1, 25), (2, 25), (5, 25)):
        exps["unpadded_centered_nb20_cnn_linear_fft_filter_{}_{}hz".format(
            lo, hi)] = _merge(KFOLD, random_kfold=False,
                              fft_filtering_low=lo, fft_filtering_high=hi)
    return exps


def experiments():
    """name -> config dict for the full generated registry."""
    exps = extra_experiments()
    exps.update(reference_experiments())  # reference names are canonical
    return exps


def write_all(out_dir):
    """Write every experiment to ``out_dir/<name>.yml`` (stale ymls there
    removed) as ``yaml.safe_dump(..., default_flow_style=False,
    sort_keys=True)`` writes it, None values dropped; returns the sorted
    names."""
    os.makedirs(out_dir, exist_ok=True)
    for stale in os.listdir(out_dir):
        if stale.endswith(".yml"):
            os.remove(os.path.join(out_dir, stale))
    exps = experiments()
    for name, conf in sorted(exps.items()):
        yamlfile.write(os.path.join(out_dir, name + ".yml"),
                       {k: v for k, v in conf.items() if v is not None})
    return sorted(exps)


def main(argv=None):
    parser = argparse.ArgumentParser(prog="deepards-generate-experiments")
    parser.add_argument("out_dir", help="directory to (re)write the "
                        "registry's .yml files in")
    args = parser.parse_args(argv)
    names = write_all(args.out_dir)
    print("wrote {} experiment files to {}".format(len(names), args.out_dir))


if __name__ == "__main__":
    main()
