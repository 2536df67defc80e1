"""Classification pretraining's parts against the JAX package's on the same
inputs: the CE and BCE losses (rtol 1e-6), the classifier metrics against
scikit-learn (within 1e-12, NaNs in the same places), ResNet-18 and -50
with carried weights (logits and features within 1e-4 in eval mode; the
BatchNorm running statistics of a train-mode pass within rtol 1e-5), and
the ``BinaryClassifier`` / ``MultiClassifier`` trainers from carried
weights with no augmentation: the epoch plans equal (``ceil(n / batch)``
steps, the last batch filled by wrapping), the step-1 loss within 1e-5,
every weight after three steps within Adam's step bound of JAX's, and
``classifier_scores.json`` equal on the same scores. Then the port alone: a
resumed run bit-equal to a straight one."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ich_tpu.train.classifier as jax_cls
from ich_tpu.data import synthetic_rsna_slices as jax_synthetic_rsna_slices
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.models import resnet as jax_resnet
from ich_tpu.ops import losses as JL
from ich_tpu.ops import metrics as JM
import ich_tpu_torch.train.classifier as cls
from ich_tpu_torch.data.core import LabeledSliceDataset
from ich_tpu_torch.data.synthetic import synthetic_rsna_slices
from ich_tpu_torch.interop.from_jax import (
    resnet_state_dict_from_jax,
    unet_encoder_state_dict_from_jax,
)
from ich_tpu_torch.models import resnet
from ich_tpu_torch.models.unet import UNetEncoder
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops import metrics as M
from ich_tpu_torch.utils import rng as prng
from ich_tpu_torch.utils.config import LOSSES, NETWORKS, TRAINERS

torch.set_num_threads(2)

ENC = dict(depth=3, top_filter=4, midchannels_factor=2, p_dropout=0.0)
TRAIN = dict(n_epoch=2, batch_size=8, lr=1e-3, seed=0)
HW = (32, 32)


def _sd(variables, convert):
    return {k: torch.from_numpy(np.array(a)) for k, a in convert(variables).items()}


@pytest.mark.parametrize("weights", [None, (0.3, 1.7)])
def test_softmax_cross_entropy_matches_jax(weights):
    rng = np.random.default_rng(0)
    logits = rng.normal(size=(13, 2)).astype(np.float32) * 3
    labels = rng.integers(0, 2, 13).astype(np.int32)
    w = None if weights is None else np.asarray(weights, np.float32)
    want = float(JL.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                          None if w is None else jnp.asarray(w)))
    got = float(L.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                        None if w is None else torch.from_numpy(w)))
    np.testing.assert_allclose(got, want, rtol=1e-6)
    reg = LOSSES.build("CrossEntropyLoss", weight=weights)
    np.testing.assert_allclose(float(reg(torch.from_numpy(logits), torch.from_numpy(labels))),
                               want, rtol=1e-6)


@pytest.mark.parametrize("pos_weight", [1.0, 3.5, [2.0]])
def test_weighted_bce_matches_jax(pos_weight):
    rng = np.random.default_rng(1)
    logits = rng.normal(size=(9, 7)).astype(np.float32) * 4
    labels = (rng.uniform(size=(9, 7)) > 0.6).astype(np.float32)
    want = float(JL.LOSSES.build("BCEWithLogitsLoss", pos_weight=pos_weight)(
        jnp.asarray(logits), jnp.asarray(labels)))
    got = float(LOSSES.build("BCEWithLogitsLoss", pos_weight=pos_weight)(
        torch.from_numpy(logits), torch.from_numpy(labels)))
    np.testing.assert_allclose(got, want, rtol=1e-6)


def _same(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        assert np.isnan(a[k]) == np.isnan(b[k]), (k, a[k], b[k])
        if not np.isnan(a[k]):
            assert abs(a[k] - b[k]) <= 1e-12, (k, a[k], b[k])


@pytest.mark.parametrize("case", ["ties", "one_class", "no_positive_prediction", "random"])
def test_classifier_metrics_match_sklearn(case):
    """Tied scores, a single-class ``y_true`` (AUC NaN), no predicted
    positive (precision and F1 0), and random draws; the multilabel
    metrics with a single-class column (macro AUC NaN)."""
    rng = np.random.default_rng({"ties": 0, "one_class": 1, "no_positive_prediction": 2,
                                 "random": 3}[case])
    for n in (7, 40, 301):
        y = rng.integers(0, 2, n)
        s = rng.uniform(size=n)
        ys = rng.integers(0, 2, (n, 7)).astype(np.float32)
        ss = rng.uniform(size=(n, 7))
        if case == "ties":
            s, ss = np.round(s, 1), np.round(ss, 1)
        elif case == "one_class":
            y[:] = 1
            ys[:, 2] = 0
        elif case == "no_positive_prediction":
            s, ss = s * 0.4, ss * 0.4
        _same(M.classification_metrics(y, s), JM.classification_metrics(y, s))
        _same(M.multilabel_metrics(ys, ss), JM.multilabel_metrics(ys, ss))
        heat, mask = rng.uniform(size=(9, 9)), rng.uniform(size=(9, 9)) > 0.7
        _same({"a": M.pixel_auc(heat, mask)}, {"a": JM.pixel_auc(heat, mask)})
        _same({"a": M.pixel_auc(heat, np.zeros((9, 9)))}, {"a": JM.pixel_auc(heat, np.zeros((9, 9)))})
    if case == "one_class":
        assert np.isnan(M.multilabel_metrics(ys, ss)["auc_macro"])


@pytest.mark.parametrize("name", ["ResNet18", "ResNet50"])
def test_resnet_matches_jax(name):
    """Eval mode: logits and features within 1e-4 at 64^2. Train mode: a
    block's BatchNorm running statistics (the downsampling block of stage
    2, on the same input) within rtol 1e-5, and the whole net's after one
    pass; over ResNet-50's 53 BatchNorms flax's one-pass variance and
    torch's two-pass one drift apart by float32 rounding, so the whole
    net is held there by each statistic's relative L2 error (1e-3), and
    element by element at rtol 1e-5 (atol 1e-6) on ResNet-18."""
    x = np.random.default_rng(0).normal(size=(4, 64, 64, 1)).astype(np.float32)
    jnet = {"ResNet18": jax_resnet.resnet18, "ResNet50": jax_resnet.resnet50}[name](num_classes=2)
    v = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    net = NETWORKS.build(name, num_classes=2, input_channels=1)
    sd = resnet_state_dict_from_jax(v)
    assert set(net.state_dict()) - set(sd) == {k for k in net.state_dict()
                                               if k.endswith("num_batches_tracked")} - set(sd)
    net.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in sd.items()}, strict=False)
    net.eval()
    jl, jf = jnet.apply(v, jnp.asarray(x), train=False, return_features=True)
    with torch.no_grad():
        logits, feats = net(torch.from_numpy(x).permute(0, 3, 1, 2), return_features=True)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), rtol=0, atol=1e-4)
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), rtol=0, atol=1e-4)

    net.train()
    with torch.no_grad():
        net(torch.from_numpy(x).permute(0, 3, 1, 2))
    _, mut = jnet.apply(v, jnp.asarray(x), train=True, mutable=["batch_stats"])
    want = resnet_state_dict_from_jax({"params": v["params"], "batch_stats": mut["batch_stats"]})
    for k, a in want.items():
        if "running" in k:
            got = net.state_dict()[k].numpy()
            if name == "ResNet18":
                np.testing.assert_allclose(got, a, rtol=1e-5, atol=1e-6, err_msg=k)
            else:
                assert np.linalg.norm(got - a) <= 1e-3 * np.linalg.norm(a), k
    # one block on the same input: its statistics at rtol 1e-5
    h = np.random.default_rng(1).normal(size=(4, 16, 16, 64 * (1 if name == "ResNet18" else 4)))
    h = h.astype(np.float32)
    jblock = (jax_resnet.BasicBlock if name == "ResNet18" else jax_resnet.Bottleneck)(
        features=128, stride=2)
    bv = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(2), jnp.asarray(h)))
    _, bmut = jblock.apply(bv, jnp.asarray(h), train=True, mutable=["batch_stats"])

    def block_sd(params, stats):  # the block's keys, through the whole-net converter
        full = resnet_state_dict_from_jax(
            {"params": {**v["params"], "stage1_block0": params},
             "batch_stats": {**v["batch_stats"], "stage1_block0": stats}})
        return {k[len("layer2.0."):]: a for k, a in full.items() if k.startswith("layer2.0.")}

    block = net.layer2[0]
    block.load_state_dict({k: torch.from_numpy(np.array(a))
                           for k, a in block_sd(bv["params"], bv["batch_stats"]).items()},
                          strict=False)
    with torch.no_grad():
        block(torch.from_numpy(h).permute(0, 3, 1, 2))
    for k, a in block_sd(bv["params"], jax.tree_util.tree_map(np.asarray, bmut["batch_stats"])
                         ).items():
        if "running" in k:
            np.testing.assert_allclose(block.state_dict()[k].numpy(), a, rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def _record(monkeypatch, jt, pt):
    """Per-step losses and batch plans of both trainers."""
    rec = {"jax": [], "port": [], "jax_plan": [], "port_plan": []}
    make = jt._make_train_step

    def make_recording():
        step = make()

        def run(state, batch, key):
            state, loss = step(state, batch, key)
            rec["jax"].append(float(loss))
            return state, loss

        return run

    jt._make_train_step = make_recording
    port_step = pt._step

    def run_port(state, batch, gen):
        loss = port_step(state, batch, gen)
        rec["port"].append(float(loss))
        return loss

    pt._step = run_port
    for mod, key in ((jax_cls, "jax_plan"), (cls, "port_plan")):
        orig = mod.batch_indices

        def recording(*a, orig=orig, key=key, **kw):
            plan = list(orig(*a, **kw))
            if kw.get("shuffle", a[2] if len(a) > 2 else False):
                rec[key].append(np.stack(plan))
            return iter(plan)

        monkeypatch.setattr(mod, "batch_indices", recording)
    return rec


@pytest.mark.parametrize("multi", [False, True])
def test_classifier_trainer_matches_jax(monkeypatch, tmp_path, multi):
    """20 slices at batch 8: 3 steps an epoch, the last batch wrapped, the
    same plans; the step-1 loss within 1e-5 and the later ones within
    1e-4; after the steps every weight within Adam's bound of JAX's; the
    scores file equal on the same scores."""
    n_out = 7 if multi else 2
    data = synthetic_rsna_slices(n_slices=20, size=32, seed=4)
    jdata = jax_synthetic_rsna_slices(n_slices=20, size=32, seed=4)
    np.testing.assert_array_equal(data.images, jdata.images)
    labels = data.labels if multi else data.labels[:, 0].astype(np.int32)
    weight = 2.0 if multi else [0.4, 1.6]
    enc_kw = dict(mlp_head=(16, n_out), **ENC)
    JT, PT = (jax_cls.MultiClassifier, cls.MultiClassifier) if multi else \
        (jax_cls.BinaryClassifier, cls.BinaryClassifier)
    jt = JT(JaxUNetEncoder(**enc_kw), class_weight=weight, **TRAIN)
    jt._ensure_state(HW, 3)
    net = UNetEncoder(**enc_kw)
    net.load_state_dict(_sd(jax.tree_util.tree_map(np.array, jt._variables()),
                            unet_encoder_state_dict_from_jax))
    pt = PT(net, class_weight=weight, device="cpu", **TRAIN)
    assert isinstance(pt, TRAINERS.get("MultiClassifier" if multi else "BinaryClassifier"))
    rec = _record(monkeypatch, jt, pt)
    jt.train(type(jdata)(jdata.images, labels))
    pt.train(LabeledSliceDataset(data.images, labels))
    assert len(rec["jax_plan"]) == len(rec["port_plan"]) == 2
    for a, b in zip(rec["jax_plan"], rec["port_plan"]):
        assert a.shape == (3, 8)
        np.testing.assert_array_equal(a, b)
        assert set(a.ravel()) == set(range(20))
    assert len(rec["jax"]) == len(rec["port"]) == 6
    np.testing.assert_allclose(rec["port"][0], rec["jax"][0], rtol=1e-5)
    np.testing.assert_allclose(rec["port"], rec["jax"], rtol=1e-4)
    hist = pt.outputs["train"]["evolution"]
    assert [r[0] for r in hist] == [1, 2] and all(r[2] is None for r in hist)

    want = unet_encoder_state_dict_from_jax(jax.tree_util.tree_map(np.array, jt._variables()))
    lrs = [pt.state.schedule(i) for i in range(pt.state.step)]
    bound = 2 * 1.005 * sum(lrs) + 1e-6  # bias-corrected Adam moves a weight <= ~lr a step
    got = pt.net.state_dict()
    for k, _ in pt.net.named_parameters():
        assert float(np.abs(got[k].numpy() - want[k]).max()) <= bound, k

    scores = np.random.default_rng(9).uniform(size=(20, n_out) if multi else 20)
    jt.predict_scores = lambda images: scores
    pt.predict_scores = lambda images: scores
    jt.evaluate(type(jdata)(jdata.images, labels), save_path=str(tmp_path / "jax"))
    pt.evaluate(LabeledSliceDataset(data.images, labels), save_path=str(tmp_path / "port"))
    j = json.loads((tmp_path / "jax" / "classifier_scores.json").read_text())
    p = json.loads((tmp_path / "port" / "classifier_scores.json").read_text())
    _same(p, j)


def test_classifier_resume_and_validation(tmp_path):
    """The real batches with an augmentation: two epochs, a checkpoint, a
    resume to three, bit-equal to three straight epochs; per-epoch
    validation metrics in the history; scores in [0, 1]."""
    data = synthetic_rsna_slices(n_slices=12, size=32, seed=5)
    binary = LabeledSliceDataset(data.images, data.labels[:, 0].astype(np.int32))

    def flip(key, x):
        keep = prng.bernoulli(key, 0.5, (x.shape[0], 1, 1, 1)).to(x.device)
        return torch.where(keep, x, x.flip(2))

    def make(n_epoch, **kw):
        torch.manual_seed(0)
        return cls.BinaryClassifier(UNetEncoder(mlp_head=(8, 2), **ENC), n_epoch=n_epoch,
                                    batch_size=5, seed=1, augment_fn=flip, device="cpu", **kw)

    path = str(tmp_path / "ckpt.bin")
    make(2, checkpoint_freq=2).train(binary.device_cache("cpu"), checkpoint_path=path)
    resumed = make(3)
    resumed.train(binary.device_cache("cpu"), valid_dataset=binary, checkpoint_path=path)
    straight = make(3)
    straight.train(binary.device_cache("cpu"), valid_dataset=binary)
    assert resumed.state.step == straight.state.step == 9
    for (k, a), b in zip(resumed.net.state_dict().items(), straight.net.state_dict().values()):
        assert torch.equal(a, b), k
    assert [r[:2] for r in resumed.outputs["train"]["evolution"]] == \
        [r[:2] for r in straight.outputs["train"]["evolution"]]
    m = straight.outputs["train"]["evolution"][-1][2]
    assert set(m) == {"accuracy", "recall", "precision", "f1", "auc"} and np.isfinite(m["auc"])
    s = straight.predict_scores(binary.images)
    assert s.shape == (12,) and ((s >= 0) & (s <= 1)).all()
    assert not straight.net.training
