"""The port's paired label-efficiency study
(``ich_tpu_torch.experiments.label_efficiency_study``) against the JAX
study (``benchmarks/label_efficiency_bench.py``) on the CPU: the data, the
folds, the label-fraction subsets and the negative subsampling are equal
arrays, the configs equal dicts and the report tables equal bytes; the
comparison flags CIs that do not overlap; and a tiny run of three arms
writes every arm x fraction x fold, its pretrained fine-tunes starting from
the pretrained weights."""

import json
import os
import sys

import numpy as np
import pytest
import torch

BENCH_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "benchmarks")
DOCS = os.path.join(os.path.dirname(BENCH_DIR), "docs")
sys.path.insert(0, BENCH_DIR)

import label_efficiency_bench as B  # noqa: E402

from ich_tpu_torch.experiments import label_efficiency_study as S  # noqa: E402
from ich_tpu_torch.experiments import pretrain_finetune as port_pf  # noqa: E402
from ich_tpu_torch.train.segmentation2d import UNet2D  # noqa: E402


@pytest.fixture(scope="module")
def both_datasets():
    return S.make_datasets(), B.make_datasets()


def _ds_equal(a, b):
    return (np.array_equal(a.images, np.asarray(b.images))
            and np.array_equal(a.masks, np.asarray(b.masks))
            and np.array_equal(a.vol_ids, np.asarray(b.vol_ids))
            and np.array_equal(a.slice_nbrs, np.asarray(b.slice_nbrs)))


def test_constants_equal_the_jax_study():
    assert (S.FRACTIONS, S.N_FOLDS, S.N_PATIENTS, S.SLICES_PER_PATIENT, S.SIZE, S.HARD) == (
        B.FRACTIONS, B.N_FOLDS, B.N_PATIENTS, B.SLICES_PER_PATIENT, B.SIZE, B.HARD)
    assert S.ARM_LABELS == B.ARM_LABELS and set(S.PRETRAINERS) == set(B.PRETRAINERS)


def test_make_datasets_equal(both_datasets):
    (lab, unl), (jlab, junl) = both_datasets
    assert lab.images.shape == (160, 64, 64) and unl.images.shape == (768, 64, 64)
    assert _ds_equal(lab, jlab) and _ds_equal(unl, junl)


def test_folds_equal(both_datasets):
    (lab, _), (jlab, _) = both_datasets
    port, jax_ = S.folds_fn(lab), B.folds_fn(jlab)
    tests = []
    for k in range(S.N_FOLDS):
        (tr, te), (jtr, jte) = port(k), jax_(k)
        assert _ds_equal(tr, jtr) and _ds_equal(te, jte)
        tests.append(np.unique(te.vol_ids))
    assert sorted(np.concatenate(tests).tolist()) == list(range(S.N_PATIENTS))


def test_subsample_negative_slices_equal(both_datasets):
    (lab, _), (jlab, _) = both_datasets
    for k in range(S.N_FOLDS):
        tr, jtr = S.folds_fn(lab)(k)[0], B.folds_fn(jlab)(k)[0]
        got = S.subsample_negative_slices(tr, 0.25, np.random.default_rng(1000 * 42 + k))
        want = B.subsample_negative_slices(jtr, 0.25, np.random.default_rng(1000 * 42 + k))
        assert _ds_equal(got, want) and len(got) < len(tr)


def _kept_patients(module, cfg, by_fold, seed, monkeypatch, n_folds):
    """{fraction: [train patients of each fold]} that ``module``'s
    ``label_efficiency_sweep`` hands the fine-tune."""
    kept = {}

    def capture(sub_cfg, pretrained, frac_folds, **kw):
        frac = sub_cfg["dataset"]["label_fraction"]
        kept[frac] = [np.unique(frac_folds(k)[0].vol_ids).tolist() for k in range(n_folds)]
        return sub_cfg["exp_name"]

    monkeypatch.setattr(module, "run_supervised_2d_with_init", capture)
    module.label_efficiency_sweep(cfg, None, by_fold, fractions=S.FRACTIONS, seed=seed)
    return kept


@pytest.mark.parametrize("seed", [42, 43])
def test_sweep_keeps_the_jax_patients(both_datasets, seed, monkeypatch, tmp_path):
    import ich_tpu.experiments.pretrain_finetune as jax_pf

    (lab, _), (jlab, _) = both_datasets
    cfg = S.base_cfg(str(tmp_path), "scratch")
    got = _kept_patients(port_pf, cfg, S.folds_fn(lab), seed, monkeypatch, S.N_FOLDS)
    want = _kept_patients(jax_pf, cfg, B.folds_fn(jlab), seed, monkeypatch, S.N_FOLDS)
    assert got == want
    assert [len(v) for v in got[0.1]] == [2] * S.N_FOLDS
    assert [len(v) for v in got[1.0]] == [16] * S.N_FOLDS


def test_configs_equal_the_jax_dicts(tmp_path):
    assert S.base_cfg(str(tmp_path), "scratch") == B.base_cfg(str(tmp_path), "scratch")
    for name in ("contrastive_pretrain", "contrastive_local_pretrain"):
        assert S._contrastive_cfg(str(tmp_path), 43, name) == B._contrastive_cfg(
            str(tmp_path), 43, name)


def _table(out_dir):
    with open(os.path.join(out_dir, "label_efficiency_table.md"), "rb") as f:
        return f.read()


def test_pooled_report_of_the_snapshots_byte_equal(tmp_path):
    port, jax_ = tmp_path / "port", tmp_path / "jax"
    port.mkdir()
    jax_.mkdir()
    got = S.pooled_report(DOCS, str(port))
    want = B.pooled_report(DOCS, str(jax_))
    assert got == want and len(got["scratch"]["0.25"]) == 40
    assert _table(port) == _table(jax_)
    assert b"+0.174 [+0.076, +0.272] (n=40, p=0.00558)" in _table(port)


def _random_results(rng, arms, fractions=S.FRACTIONS):
    return {arm: {str(f): rng.uniform(0, 1, S.N_FOLDS).tolist() for f in fractions}
            for arm in arms}


# the cases of tests/test_benchmark_drivers.py: two arms, three arms,
# mixed two- and three-arm seeds, a partial fraction grid, an arm missing a
# fraction, and all four arms
REPORT_CASES = {
    "two_arms": lambda rng: [_random_results(rng, ("scratch", "pretrained"))] * 2,
    "three_arms": lambda rng: [_random_results(rng, ("scratch", "pretrained", "contrastive"))],
    "two_and_three_arm_seeds": lambda rng: [
        _random_results(rng, ("scratch", "pretrained")),
        _random_results(rng, ("scratch", "pretrained", "contrastive"))],
    "partial_fractions": lambda rng: [{arm: {"0.25": [0.1, 0.2]}
                                       for arm in ("scratch", "pretrained")}],
    "arm_missing_a_fraction": lambda rng: [{
        "scratch": {"0.1": [0.1, 0.2], "0.25": [0.3, 0.4]}, "pretrained": {"0.1": [0.2, 0.3]}}],
    "four_arms": lambda rng: [_random_results(rng, S.ARMS)],
}


@pytest.mark.parametrize("case", sorted(REPORT_CASES))
def test_report_equals_the_jax_report(case, tmp_path, capsys):
    runs = REPORT_CASES[case](np.random.default_rng(0))
    for i, res in enumerate(runs):
        (tmp_path / "runs" / f"seed{42 + i}").mkdir(parents=True)
        (tmp_path / "runs" / f"seed{42 + i}" / "results.json").write_text(json.dumps(res))
    tables = []
    for name, mod in (("port", S), ("jax", B)):
        out = tmp_path / name
        out.mkdir()
        if len(runs) == 1:
            mod.report(runs[0], str(out))
        else:
            mod.pooled_report(str(tmp_path / "runs"), str(out))
        tables.append(_table(out))
    assert tables[0] == tables[1]
    assert capsys.readouterr().out.count("| labels |") == 2


def _write_runs(d, prefix, runs):
    d.mkdir(exist_ok=True)
    for i, res in enumerate(runs):
        (d / f"{prefix}{42 + i}.json").write_text(json.dumps(res))


def test_compare_to_reference_flags_non_overlap(tmp_path):
    rng = np.random.default_rng(3)
    ref = [{arm: {"0.25": (0.2 + 0.05 * rng.standard_normal(5)).tolist()}
            for arm in ("scratch", "pretrained")} for _ in range(4)]
    same = [{arm: {"0.25": (0.2 + 0.05 * rng.standard_normal(5)).tolist()}
             for arm in ("scratch", "pretrained")} for _ in range(4)]
    shifted = [{"scratch": r["scratch"],
                "pretrained": {"0.25": (np.asarray(r["pretrained"]["0.25"]) + 0.5).tolist()}}
               for r in same]
    _write_runs(tmp_path / "ref", "label_efficiency_seed", ref)
    _write_runs(tmp_path / "ok", "seed", same)
    _write_runs(tmp_path / "bad", "seed", shifted)
    assert S.compare_to_reference(str(tmp_path / "ok"), str(tmp_path / "ref")) == []
    apart = S.compare_to_reference(str(tmp_path / "bad"), str(tmp_path / "ref"))
    assert {(r["arm"], r["quantity"]) for r in apart} == {
        ("pretrained", "Dice"), ("pretrained", "paired Δ")}
    assert apart[1]["port_excludes_zero"]
    # 4 seeds x 5 folds train from streams 42-49: each side's CI widens
    # from 20 cells to 8 streams; the +0.5 shift still excludes zero
    assert all(r["differs"] and r["difference"][2:] == (8, 8) for r in apart)
    for r in apart:
        (mp, hp, n_p), (mr, hr, n_r) = r["port"], r["reference"]
        assert n_p == n_r == 20
        assert np.allclose(r["difference"][:2],
                           (mp - mr, np.sqrt(20 / 8) * np.hypot(hp, hr)), rtol=1e-12)
    ok_text = (tmp_path / "ok" / "comparison.md").read_text()
    assert "0 of 3 port − JAX differences exclude zero" in ok_text
    assert "The CR arm's paired Δ at 25% labels: port " in ok_text
    text = (tmp_path / "bad" / "comparison.md").read_text()
    assert "**no**" in text and "2 of 3 pairs of CIs do not overlap." in text
    assert "2 of 3 port − JAX differences exclude zero" in text
    assert text.count("(8, 8) | **yes** |") == 2


def test_snapshot_docs_of_the_jax_snapshots_overlap_themselves(tmp_path):
    """The JAX snapshots copied under the port's names hold against
    themselves: every pair overlaps, and table.md carries both tables."""
    import shutil

    for fn in os.listdir(DOCS):
        if fn.startswith("label_efficiency_") and fn.endswith(".json"):
            shutil.copy(os.path.join(DOCS, fn),
                        tmp_path / fn.replace("label_efficiency_", ""))
    assert S.write_snapshot_docs(str(tmp_path), DOCS) == []
    table = (tmp_path / "table.md").read_text()
    assert "## Main sweep" in table and "## 10%-labels rescue probe" in table
    assert "+0.174 [+0.076, +0.272] (n=40, p=0.00558)" in table
    comparison = (tmp_path / "comparison.md").read_text()
    assert comparison.count("| yes |") == 16 + 12 + 2 + 1
    assert "0 of 31 port − JAX differences exclude zero" in comparison
    assert "+0.174 [+0.076, +0.272] (n=40), which excludes zero" in comparison
    # 8 seeds x 5 folds share 12 streams, 5 seeds 9, the 2 rescue seeds 6
    assert comparison.count("(12, 12) |") == 4 + 2 * 8
    assert comparison.count("(9, 9) |") == 2 * 4 and comparison.count("(6, 6) |") == 3


def test_committed_port_docs_are_what_their_snapshots_give(tmp_path):
    """``docs/torch_label_efficiency/``'s ``table.md`` and ``comparison.md``
    are ``write_snapshot_docs`` of its committed snapshots and provenance,
    byte for byte."""
    import shutil

    port_docs = os.path.join(DOCS, "torch_label_efficiency")
    for fn in os.listdir(port_docs):
        if fn.endswith(".json"):
            shutil.copy(os.path.join(port_docs, fn), tmp_path / fn)
    S.write_snapshot_docs(str(tmp_path), DOCS)
    for doc in ("table.md", "comparison.md"):
        with open(os.path.join(port_docs, doc)) as f:
            assert (tmp_path / doc).read_text() == f.read(), doc


def test_committed_provenance_records_the_study_draws():
    """Every arm of ``docs/torch_label_efficiency/provenance.json`` ran
    with the draws the study makes today (``DRAWS``): snapshots taken
    before a change to the port's draws hold nets or masks it no longer
    draws, and their table says nothing of the port as it stands."""
    with open(os.path.join(DOCS, "torch_label_efficiency", "provenance.json")) as f:
        provenance = json.load(f)
    assert list(provenance) == list(S.ARMS)
    assert {arm: info.get("draws") for arm, info in provenance.items()} == {
        arm: S.DRAWS for arm in S.ARMS}


def test_snapshot_paths_read_the_snapshots_only(tmp_path):
    """A stray ``*/results.json`` beside the snapshots (a seed dir left in
    place) feeds neither the tables nor the comparison, while
    ``pooled_report`` without a prefix pools the seed dirs first, as the
    JAX study does."""
    rng = np.random.default_rng(5)

    def runs(shift):
        return [{arm: {"0.25": (0.2 + shift + 0.05 * rng.standard_normal(5)).tolist()}
                 for arm in ("scratch", "pretrained")} for _ in range(3)]

    _write_runs(tmp_path / "ref", "label_efficiency_seed", runs(0.0))
    _write_runs(tmp_path / "port", "seed", runs(0.0))
    for d in ("ref", "port"):  # far from both: would not overlap if read
        (tmp_path / d / "seed99").mkdir()
        (tmp_path / d / "seed99" / "results.json").write_text(json.dumps(runs(0.6)[0]))
    assert S.write_snapshot_docs(str(tmp_path / "port"), str(tmp_path / "ref")) == []
    table = (tmp_path / "port" / "table.md").read_text()
    assert "(n=15, " in table and "## 10%-labels rescue probe" not in table
    assert "(n=15) | yes |" in (tmp_path / "port" / "comparison.md").read_text()
    pooled = S.pooled_report(str(tmp_path / "port"), str(tmp_path))
    assert len(pooled["scratch"]["0.25"]) == 5 and np.mean(pooled["scratch"]["0.25"]) > 0.6


def test_snapshot_docs_are_headed_by_the_runs_provenance(tmp_path):
    """``provenance.json`` (per arm, as ``main`` writes it) heads
    ``table.md`` and ``comparison.md``, grouping the arms that ran alike."""
    rng = np.random.default_rng(6)
    res = [{arm: {"0.25": (0.2 + 0.05 * rng.standard_normal(5)).tolist()}
            for arm in ("scratch", "pretrained")} for _ in range(2)]
    _write_runs(tmp_path / "ref", "label_efficiency_seed", res)
    _write_runs(tmp_path / "port", "seed", res)
    card = {"torch": "2.11.0+cu128", "cuda": "12.8", "device": "NVIDIA H100 80GB HBM3",
            "cudnn_tf32": True, "matmul_tf32": False}
    (tmp_path / "port" / "provenance.json").write_text(json.dumps(
        {"scratch": card, "pretrained": {**card, "torch": "2.13.0"}}))
    S.write_snapshot_docs(str(tmp_path / "port"), str(tmp_path / "ref"))
    want = ("Runs made with scratch: torch 2.11.0+cu128 (CUDA 12.8) on NVIDIA H100 80GB HBM3, "
            "cuDNN TF32 on, matmul TF32 off; CR-pretrained: torch 2.13.0 (CUDA 12.8) on "
            "NVIDIA H100 80GB HBM3, cuDNN TF32 on, matmul TF32 off.\n\n")
    for doc in ("table.md", "comparison.md"):
        assert (tmp_path / "port" / doc).read_text().startswith(want), doc


def test_main_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        S.main(str(tmp_path), scale={"n_folds": 2, "n_epoch": 1, "pretrain_epochs": 1,
                                     "size": 16})


# 32 px: the local phase's region NT-Xent needs 13 cells of 3x3 on the
# partial decoder's map, at half the input's side
TINY = {"n_folds": 2, "n_epoch": 1, "pretrain_epochs": 1, "size": 32}
TINY_ARMS = ("scratch", "pretrained", "contrastive_local")
# where each arm's pretrained weights are saved, under out_root
PRETRAINED_BIN = {"pretrained": "cr_pretrain/pretrain/pretrained.bin",
                  "contrastive_local": "contrastive_local_pretrain/pretrain_local/pretrained.bin"}


def test_tiny_study_runs_every_arm_and_starts_from_the_pretrained_weights(tmp_path,
                                                                         monkeypatch):
    from ich_tpu_torch.train import checkpoint as ckpt

    starts = {}
    train = UNet2D.train

    def recording_train(self, dataset, valid_dataset=None, checkpoint_path=None):
        fold_dir = os.path.dirname(checkpoint_path)
        if fold_dir.endswith("Fold_1"):
            starts[os.path.basename(os.path.dirname(fold_dir))] = {
                k: v.detach().clone() for k, v in self.unet.state_dict().items()}
        return train(self, dataset, valid_dataset, checkpoint_path)

    monkeypatch.setattr(UNet2D, "train", recording_train)
    # as on the card's machine: no report PDF or figure drawn
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    out = str(tmp_path / "seed42")
    results = S.main(out, seed=42, arms=TINY_ARMS, device="cpu", scale=TINY)
    with open(os.path.join(out, "results.json")) as f:
        assert json.load(f) == results
    assert list(results) == list(TINY_ARMS)
    for arm in TINY_ARMS:
        assert list(results[arm]) == [str(f) for f in S.FRACTIONS]
        for vals in results[arm].values():
            assert len(vals) == 2 and all(0.0 <= v <= 1.0 for v in vals)
    assert (tmp_path / "seed42" / "label_efficiency_table.md").exists()
    assert not (tmp_path / "seed42" / "label_efficiency.png").exists()

    for arm, rel in PRETRAINED_BIN.items():
        pre = ckpt.load_params(os.path.join(out, rel))
        for frac in S.FRACTIONS:
            start = starts[f"{arm}_frac{int(frac * 100)}"]
            scratch = starts[f"scratch_frac{int(frac * 100)}"]
            moved = [k for k in start if k in pre and tuple(pre[k].shape) == tuple(start[k].shape)]
            assert moved, arm
            assert all(torch.equal(start[k], torch.as_tensor(pre[k])) for k in moved), arm
            assert any(not torch.equal(start[k], scratch[k]) for k in moved
                       if start[k].is_floating_point()), arm
    # context restoration moves the whole U-Net, the local phase the
    # encoder and the first decoder stages
    n_keys = len(starts["scratch_frac10"])
    pre_cr = ckpt.load_params(os.path.join(out, PRETRAINED_BIN["pretrained"]))
    assert sum(k in pre_cr for k in starts["pretrained_frac10"]) == n_keys
    pre_local = ckpt.load_params(os.path.join(out, PRETRAINED_BIN["contrastive_local"]))
    local_keys = [k for k in starts["contrastive_local_frac10"] if k in pre_local]
    assert any(k.startswith("up_samp") or k.startswith("up_block") for k in local_keys)
    assert sum(k.startswith("down_block") for k in local_keys) > 0

    # a second run of one more arm merges into results.json
    more = S.main(out, seed=42, arms=("contrastive",), device="cpu", scale=TINY)
    assert list(more) == list(TINY_ARMS) + ["contrastive"]
    # and so does provenance.json, one entry an arm
    with open(os.path.join(out, "provenance.json")) as f:
        provenance = json.load(f)
    assert list(provenance) == list(more)
    assert all(p == {"torch": torch.__version__, "cuda": torch.version.cuda, "device": "cpu",
                     "cudnn_tf32": torch.backends.cudnn.allow_tf32,
                     "matmul_tf32": torch.backends.cuda.matmul.allow_tf32,
                     "draws": S.DRAWS}
               for p in provenance.values())

