"""The port's experiment reports (``postprocessing/analyse_exp.py``) and plot
helpers (``postprocessing/plots.py``) against the JAX package's, on the
CPU. The k-fold folder is written by the port's k-fold experiment from a
SegICH 2D CSV tree (its CSVs are the JAX experiment's bytes); on it the
port's tables (fold curves, confusion groups, Dice groups, the ranked
picks and the overlay grid) equal those the JAX report computes with
pandas, the overlay triplets equal JAX's helpers' exactly, and both PDFs
draw the same artists (line, bar, scatter and image data equal) on the
same number of pages. Each plot helper draws the JAX helper's artists on
the same data."""

import json
import os

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pandas as pd  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from ich_tpu.postprocessing import analyse_exp as jax_analyse  # noqa: E402
from ich_tpu.postprocessing import plots as jax_plots  # noqa: E402
from ich_tpu_torch.data.synthetic import synthetic_ich_slices, write_segich_tree  # noqa: E402
from ich_tpu_torch.experiments.supervised2d import run_supervised_2d  # noqa: E402
from ich_tpu_torch.postprocessing import analyse_exp, plots  # noqa: E402

from _mpl_artists import _artists, _assert_same_artists, drawn  # noqa: E402,F401

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FOLD, N_OVERLAY = 2, 4


def _pdf_pages(path):
    import re

    with open(path, "rb") as f:
        return len(re.findall(rb"/Type\s*/Page\b(?!s)", f.read()))


@pytest.fixture(scope="module")
def kfold(tmp_path_factory):
    """A 2-fold ``run_supervised_2d`` on a SegICH 2D CSV tree of 40² slices
    at a 32² net input (so the overlays' nearest resize runs), with
    per-epoch validation (so the Dice curves exist). Returns (exp folder,
    data dir)."""
    root = tmp_path_factory.mktemp("kfold")
    data = str(root / "data")
    write_segich_tree(synthetic_ich_slices(n_slices=36, size=40, n_volumes=6, seed=5), data)
    with open(os.path.join(ROOT, "configs", "unet2d.json")) as f:
        cfg = json.load(f)
    cfg["exp_name"] = "exp"
    cfg["path"] = {"DATA": data, "OUTPUT": str(root / "out")}
    cfg["split"]["n_fold"] = N_FOLD
    cfg["data"]["size"] = 32
    cfg["net"].update(depth=3, top_filter=8)
    cfg["train"].update({"n_epoch": 2, "batch_size": 8, "validate_epoch": True})
    return run_supervised_2d(cfg, device="cpu"), data


def _jax_tables(exp, n_fold, n_overlay):
    """The tables JAX's ``analyse_supervised_exp`` computes inline, with
    pandas, as its code reads."""
    results_df = pd.read_csv(os.path.join(exp, "all_volume_prediction.csv"), index_col=0)
    slice_dfs = []
    for i in range(n_fold):
        df = pd.read_csv(os.path.join(exp, f"Fold_{i + 1}/pred/slice_prediction_scores.csv"),
                         index_col=0)
        df["Fold"] = i + 1
        slice_dfs.append(df)
    slice_df = pd.concat(slice_dfs, axis=0).reset_index(drop=True)
    cm = ["TP", "TN", "FP", "FN"]
    ranked = slice_df.loc[slice_df.label == 1].sort_values("Dice")
    grid = [list(slice_df[slice_df.label == lab].sort_values("Dice", ascending=asc)
                 .iloc[:n_overlay].index) for asc, lab, _ in analyse_exp.GRID_SPECS]
    return {
        "confusion": [results_df[cm].values, results_df.loc[results_df.label == 1, cm].values,
                      results_df.loc[results_df.label == 0, cm].values],
        "dice_groups": [results_df[["Dice"]].values, slice_df[["Dice"]].values],
        "picks": list(ranked.index[:2]) + list(ranked.index[-1:]),
        "grid": grid, "slice_df": slice_df,
    }


def test_supervised_tables_equal_jax(kfold):
    exp, _ = kfold
    got = analyse_exp.supervised_tables(exp, N_FOLD, N_OVERLAY)
    want = _jax_tables(exp, N_FOLD, N_OVERLAY)
    hist = jax_analyse._load_fold_histories(exp)
    assert len(got["hist"]) == len(hist) == N_FOLD
    for a, b in zip(got["hist"], hist):
        np.testing.assert_array_equal(a, b)
    assert got["curve_names"] == ["Train Loss", "Dice (all)", "Dice (ICH)"]
    assert got["curves"][0].shape == (2, 1 + N_FOLD)
    for key in ("confusion", "dice_groups"):
        assert len(got[key]) == len(want[key])
        for a, b in zip(got[key], want[key]):
            np.testing.assert_array_equal(a, b)
    assert got["picks"] == want["picks"] and len(got["picks"]) == 3
    assert got["grid"] == want["grid"]
    # ties in Dice (the empty predictions of negative slices) decide the grid
    dice = want["slice_df"].Dice.values
    assert len(np.unique(dice)) < len(dice)
    for col in ("volID", "slice", "label", "Fold", "Dice"):
        np.testing.assert_array_equal(got["slices"][col], want["slice_df"][col].values)
    assert got["window"] == jax_analyse._exp_window(exp) == (50.0, 200.0)


@pytest.mark.parametrize("values,ascending", [
    ([0.5, 1.0, 1.0, 0.2, np.nan, 1.0, 0.2, 0.7] * 5, True),
    ([0.5, 1.0, 1.0, 0.2, np.nan, 1.0, 0.2, 0.7] * 5, False),
    (list(np.random.default_rng(3).integers(0, 4, 200).astype(float)), False),
])
def test_nargsort_equals_pandas_sort_values(values, ascending):
    df = pd.DataFrame({"Dice": values})
    want = df.sort_values("Dice", ascending=ascending).index.to_numpy()
    np.testing.assert_array_equal(analyse_exp.nargsort(np.asarray(values), ascending), want)


def test_overlay_triplets_equal_jax(kfold):
    """Every slice of the picks and the grid: CT, target and prediction
    equal to JAX's helpers' (PIL reads, scipy's nearest zoom), and the
    slice files found the same way."""
    exp, data = kfold
    t = analyse_exp.supervised_tables(exp, N_FOLD, N_OVERLAY)
    slice_df = _jax_tables(exp, N_FOLD, N_OVERLAY)["slice_df"]
    rows = sorted(set(t["picks"]) | {i for g in t["grid"] for i in g})
    n_ct = 0
    for i in rows:
        got = analyse_exp.load_overlay_triplet(exp, data, analyse_exp.slice_row(t["slices"], i),
                                               t["window"])
        want = jax_analyse._load_overlay_triplet(exp, data, slice_df.loc[i], t["window"])
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape == (40, 40)
                np.testing.assert_array_equal(a, b)
        n_ct += got[0] is not None
        row = slice_df.loc[i]
        assert (analyse_exp.find_slice_files(data, int(row.volID), int(row["slice"]))
                == jax_analyse._find_slice_files(data, int(row.volID), int(row["slice"])))
    assert n_ct == len(rows) > 0
    # the reference's PhysioNet fallback layout, and a slice absent from both
    assert analyse_exp.find_slice_files(data, 999, 0) == (None, None)
    assert jax_analyse._find_slice_files(data, 999, 0) == (None, None)


def test_supervised_pdf_draws_jax_artists(kfold, tmp_path, drawn):
    exp, data = kfold
    want_fn = jax_analyse.analyse_supervised_exp(exp, data, N_FOLD, str(tmp_path / "j.pdf"),
                                                 N_OVERLAY)
    want = list(drawn)
    drawn.clear()
    got_fn = analyse_exp.analyse_supervised_exp(exp, data, N_FOLD, str(tmp_path / "p.pdf"),
                                                N_OVERLAY)
    assert len(drawn) == len(want) == 2 == _pdf_pages(got_fn) == _pdf_pages(want_fn)
    for g, w in zip(drawn, want):
        _assert_same_artists(g, w)
    assert sum(len(a["images"]) for a in drawn[1]) >= 3 * N_OVERLAY  # overlays drawn


def test_kfold_experiment_writes_results_overview(kfold):
    exp, _ = kfold
    assert _pdf_pages(os.path.join(exp, "results_overview.pdf")) == 2


def test_representation_pdf_draws_jax_artists(tmp_path, drawn):
    rng = np.random.default_rng(0)
    evo = [[e, 1.0 / (e + 1)] for e in range(1, 6)]
    payload = np.concatenate([rng.normal(size=(30, 2)), rng.integers(0, 2, (30, 1))], 1)
    for name, repr_ in (("with", payload.tolist()), ("without", None)):
        d = tmp_path / name
        os.makedirs(d)
        with open(d / "outputs.json", "w") as f:
            json.dump({"train": {"evolution": evo}, "eval": {"repr": repr_}}, f)
        drawn.clear()
        jax_analyse.analyse_representation_exp(str(d), str(d / "j.pdf"))
        analyse_exp.analyse_representation_exp(str(d), str(d / "p.pdf"))
        assert len(drawn) == 2 and _pdf_pages(d / "p.pdf") == _pdf_pages(d / "j.pdf") == 1
        _assert_same_artists(drawn[1], drawn[0])
        t = analyse_exp.representation_tables(str(d))
        assert (t["embedding"] is None) == (repr_ is None)


def _draw(fn):
    fig, ax = plt.subplots()
    ret = fn(ax)
    art = _artists(fig)
    plt.close(fig)
    return art, ret


HELPERS = {
    "draw_curved_rect": lambda m, ax: m.draw_curved_rect(0.5, 2.0, 0, 3, 1, 5, ax=ax),
    "curve_std": lambda m, ax: m.curve_std(
        [np.c_[np.arange(5), np.random.default_rng(0).normal(size=(5, 3))],
         np.c_[np.arange(5), np.r_[np.ones((4, 3)), np.full((1, 3), np.nan)]]],
        ["a", "b"], ax=ax),
    "metric_barplot": lambda m, ax: m.metric_barplot(
        [np.random.default_rng(1).uniform(size=(9, 3)), np.random.default_rng(2).uniform(size=(4, 3))],
        ["s1", "s2"], ["g1", "g2", "g3"], ax=ax, display_val=True),
    "add_stat_significance": lambda m, ax: m.add_stat_significance(
        [(0, 1), (0, 2)], [np.arange(10.0), np.arange(10.0) + 5, np.arange(10.0) + 0.5], ax=ax),
    "add_stat_significance_ttest": lambda m, ax: m.add_stat_significance(
        [(0, 1)], [np.arange(8.0), np.arange(8.0) * 2], ax=ax, test="ttest"),
    "imshow_pred": lambda m, ax: m.imshow_pred(
        np.linspace(0, 1, 64).reshape(8, 8), np.eye(8), target=np.fliplr(np.eye(8)), ax=ax),
    "plot_tsne_labels": lambda m, ax: m.plot_tsne(
        np.random.default_rng(4).normal(size=(20, 2)), np.arange(20) % 3, ax=ax,
        legend_names=["x", "y", "z"]),
    "plot_tsne": lambda m, ax: m.plot_tsne(np.random.default_rng(5).normal(size=(20, 2)), ax=ax),
    "boxplot_hist": lambda m, ax: m.boxplot_hist(
        [np.random.default_rng(6).normal(size=50), np.r_[np.random.default_rng(7).normal(size=40),
                                                         np.nan]], ["a", "b"], ax=ax, bins=8),
    "boxplot_hist_horizontal": lambda m, ax: m.boxplot_hist(
        [np.random.default_rng(8).normal(size=50)], ["a"], ax=ax, bins=8, horizontal=True),
}


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_plot_helper_draws_jax_artists(name):
    got, got_ret = _draw(lambda ax: HELPERS[name](plots, ax))
    want, want_ret = _draw(lambda ax: HELPERS[name](jax_plots, ax))
    _assert_same_artists(got, want)
    if name.startswith("add_stat"):
        assert got_ret == want_ret and len(got_ret) > 0


def test_pred2gif_equals_jax(tmp_path):
    rng = np.random.default_rng(9)
    images = [rng.uniform(size=(16, 16)) for _ in range(3)]
    preds = [rng.uniform(size=(16, 16)) > 0.7 for _ in range(3)]
    plots.pred2gif(images, preds, str(tmp_path / "p.gif"), targets=preds, fps=2)
    jax_plots.pred2gif(images, preds, str(tmp_path / "j.gif"), targets=preds, fps=2)
    with open(tmp_path / "p.gif", "rb") as a, open(tmp_path / "j.gif", "rb") as b:
        assert a.read() == b.read()
