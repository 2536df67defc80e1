"""The port's losses, schedules, optimizer, BatchNorm update, fresh-init
distributions, fold aggregate and fold split against the JAX package (and
scikit-learn for the split), on the same numpy inputs."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.model_selection import StratifiedKFold

from ich_tpu.models import UNet as JaxUNet
from ich_tpu.ops import losses as JL
from ich_tpu.ops.metrics import fold_aggregate as jax_fold_aggregate
from ich_tpu.train import state as JS
from ich_tpu_torch.experiments.supervised2d import build_unet_from_cfg, stratified_kfold
from ich_tpu_torch.models.layers import make_norm
from ich_tpu_torch.models.unet import UNet
from ich_tpu_torch.ops import losses as L
from ich_tpu_torch.ops.metrics import fold_aggregate
from ich_tpu_torch.train import state as S
from ich_tpu_torch.utils.config import LOSSES

torch.set_num_threads(2)


def _pred_mask(seed, shape=(4, 16, 16, 1)):
    rng = np.random.default_rng(seed)
    pred = rng.uniform(0.01, 0.99, size=shape).astype(np.float32)
    mask = (rng.uniform(size=shape) > 0.7).astype(np.float32)
    mask[1] = 0.0  # an empty mask: the alpha branch
    return pred, mask


LOSS_CASES = {
    "dice_p2_alpha0.2": (JL.binary_dice_loss, L.binary_dice_loss,
                         dict(reduction="mean", p=2, alpha=0.2)),
    "dice_p1_sum": (JL.binary_dice_loss, L.binary_dice_loss, dict(reduction="sum", p=1)),
    "dice_none": (JL.binary_dice_loss, L.binary_dice_loss, dict(reduction="none", alpha=0.5)),
    "tversky": (JL.tversky_loss, L.tversky_loss, dict(alpha=0.3, beta=0.7, gamma=0.3)),
    "combo": (JL.combo_loss, L.combo_loss, dict(alpha=0.4, beta=0.6, p=2)),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_and_gradient_match_jax(case):
    """Values within rtol 1e-6, gradients within rtol 1e-5 (float32, the
    same formulas; the sums run in another order)."""
    jfn, pfn, kw = LOSS_CASES[case]
    pred, mask = _pred_mask(len(case))

    def jloss(p):
        return jnp.sum(jfn(p, jnp.asarray(mask), **kw))

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got_all = pfn(p, torch.from_numpy(mask), **kw)
    got = got_all.sum()
    got.backward()
    np.testing.assert_allclose(got_all.detach().numpy(),
                               np.asarray(jfn(jnp.asarray(pred), jnp.asarray(mask), **kw)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=1e-9)


def test_loss_registry_drops_device_and_keeps_names():
    pred, mask = _pred_mask(0)
    fn = LOSSES.build("BinaryDiceLoss", reduction="mean", p=2, alpha=0.2, device="cuda:0")
    want = JL.binary_dice_loss(jnp.asarray(pred), jnp.asarray(mask), p=2, alpha=0.2)
    np.testing.assert_allclose(float(fn(torch.from_numpy(pred), torch.from_numpy(mask))),
                               float(want), rtol=1e-6)
    for name in ("BinaryDiceLoss", "TverskyLoss", "ComboLoss", "DiscountedL1"):
        assert name in LOSSES


SCHEDULE_CASES = {
    "ExponentialLR": {"gamma": 0.96},
    "StepLR": {"step_size": 2, "gamma": 0.5},
    "CosineAnnealingLR": {"T_max": 4, "eta_min": 1e-5},
    "ConstantLR": {},
    "MultiStepLR": {"milestones": (4, 1), "gamma": 0.3},
}


@pytest.mark.parametrize("name", sorted(SCHEDULE_CASES))
def test_schedule_matches_jax(name):
    """Steps 0..40 with 7 steps per epoch, within rtol 1e-6 (the JAX
    closed forms run in float32, the port's in float64)."""
    kw = SCHEDULE_CASES[name]
    want = JS.make_schedule(name, 1e-3, 7, **kw)
    got = S.make_schedule(name, 1e-3, 7, **kw)
    w = np.asarray([float(want(jnp.int32(s))) for s in range(41)])
    g = np.asarray([got(s) for s in range(41)])
    np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-12)
    assert all(g[s] == g[s - s % 7] for s in range(41))  # constant within an epoch
    assert (len(set(g)) > 1) == (name != "ConstantLR")


@pytest.mark.parametrize("grad_clip", [None, 0.5])
def test_adam_l2_matches_optax_chain(grad_clip):
    """Five updates on the same gradients: torch Adam with L2 weight decay
    against ``make_optimizer`` (add_decayed_weights -> scale_by_adam ->
    the schedule), within rtol 1e-5. The gradients are well away from 0:
    Adam's first update is about lr * sign(g), so a gradient that is
    rounding noise could go either way in the two packages."""
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), (2, 2, 3)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.choice([-1, 1], size=s) * rng.uniform(0.1, 1.0, size=s)).astype(np.float32)
              for s in shapes] for _ in range(5)]
    kw = dict(weight_decay=1e-2, grad_clip=grad_clip)

    sched = JS.make_schedule("ExponentialLR", 1e-2, 2, gamma=0.5)
    tx = JS.make_optimizer(sched, **kw)
    jp = [jnp.asarray(p) for p in params]
    opt_state = tx.init(jp)
    for g in grads:
        upd, opt_state = tx.update([jnp.asarray(x) for x in g], opt_state, jp)
        jp = [p + u for p, u in zip(jp, upd)]

    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in params]
    net = torch.nn.Module()
    for i, p in enumerate(tp):
        net.register_parameter(f"p{i}", p)
    st = S.TrainState(net, S.make_optimizer(tp, 1e-2, **kw),
                      S.make_schedule("ExponentialLR", 1e-2, 2, gamma=0.5))
    for g in grads:
        for p, x in zip(tp, g):
            p.grad = torch.from_numpy(x.copy())
        st.apply_gradients()
    assert st.step == 5
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_batchnorm_running_stats_match_flax():
    """Train mode: outputs with the batch's statistics, and the running
    mean and the biased running variance updated as flax does (momentum
    0.9), within rtol 1e-5; eval mode then normalises with them."""
    rng = np.random.default_rng(1)
    xs = [rng.normal(1.0, 2.0, size=(3, 5, 6, 4)).astype(np.float32) for _ in range(2)]
    bn = fnn.BatchNorm(momentum=0.9, epsilon=1e-5)
    variables = bn.init(jax.random.PRNGKey(0), jnp.asarray(xs[0]), use_running_average=False)
    port = make_norm("batch", 4, 2).train()
    for x in xs:
        want, upd = bn.apply(variables, jnp.asarray(x), use_running_average=False,
                             mutable=["batch_stats"])
        variables = {**variables, **upd}
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    stats = variables["batch_stats"]
    np.testing.assert_allclose(port.running_mean.numpy(), np.asarray(stats["mean"]), rtol=1e-5)
    np.testing.assert_allclose(port.running_var.numpy(), np.asarray(stats["var"]), rtol=1e-5)
    unbiased = torch.nn.BatchNorm2d(4, momentum=0.1)
    unbiased(torch.from_numpy(xs[0]).permute(0, 3, 1, 2))
    assert not np.allclose(unbiased.running_var.numpy(),
                           0.9 + 0.1 * xs[0].reshape(-1, 4).var(axis=0), rtol=1e-5)
    port.eval()
    x = torch.from_numpy(xs[1]).permute(0, 3, 1, 2)
    want = bn.apply(variables, jnp.asarray(xs[1]), use_running_average=True)
    np.testing.assert_allclose(port(x).permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-5)


def test_fresh_init_matches_flax_distributions():
    """Every conv and transposed-conv kernel with at least 4096 weights has
    a standard deviation within 5% of the flax init's for the same layer
    (lecun_normal: a normal truncated at 2 std with std sqrt(1/fan_in),
    fan_in I * prod(k), also for flax's (*k, I, O) transposed kernel);
    biases are 0, BatchNorm scale 1 and bias 0."""
    kw = dict(depth=3, top_filter=32, midchannels_factor=1, norm="batch")
    jnet = JaxUNet(p_dropout=0.0, **kw)
    from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax

    v = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
    flax_sd = unet_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, v))
    net = build_unet_from_cfg({"depth": 3, "top_filter": 32, "midchannels_factor": 1,
                               "p_dropout": 0.0}, seed=0)
    sd = net.state_dict()
    assert sd.keys() == flax_sd.keys()
    checked = 0
    for k, t in sd.items():
        t = t.double().numpy()
        if k.endswith(".weight") and t.ndim == 4:
            fan_in = t.shape[1] * 4 if k.startswith("up_samp") else t[0].size
            assert np.abs(t).max() <= 2.0 * (1.0 / fan_in) ** 0.5 / 0.8796 + 1e-6, k
            if t.size >= 4096:
                ratio = t.std() / flax_sd[k].std()
                assert abs(ratio - 1.0) <= 0.05, (k, ratio)
                checked += 1
        elif k.endswith(".bias") and "bn" not in k:
            assert not t.any(), k
        elif "bn" in k and k.endswith(".weight"):
            assert np.all(t == 1.0), k
    assert checked >= 8
    # a fresh net from the same seed is the same net; the global RNG is left as it was
    state = torch.random.get_rng_state()
    again = build_unet_from_cfg({"depth": 3, "top_filter": 32, "midchannels_factor": 1,
                                 "p_dropout": 0.0}, seed=0)
    assert torch.equal(torch.random.get_rng_state(), state)
    assert all(torch.equal(a, b) for a, b in zip(again.state_dict().values(), sd.values()))
    assert isinstance(UNet(depth=2, top_filter=4).down_block[0].bn1, torch.nn.BatchNorm2d)


def test_fold_aggregate_matches_jax():
    v = np.random.default_rng(2).uniform(size=10)
    assert fold_aggregate(v) == jax_fold_aggregate(v)


LABELS = {
    "balanced": np.array([0, 1] * 15),
    "skewed": np.array([0] * 40 + [1] * 9),
    "three_classes_unsorted": np.random.default_rng(3).integers(0, 3, size=37)[::-1] + 1,
}


@pytest.mark.parametrize("labels", sorted(LABELS))
@pytest.mark.parametrize("seed", [0, 1, 7, 42, 1234])
def test_stratified_kfold_equals_sklearn(labels, seed):
    y = LABELS[labels]
    want = list(StratifiedKFold(n_splits=5, shuffle=True, random_state=seed)
                .split(np.zeros(len(y)), y))
    got = list(stratified_kfold(y, 5, shuffle=True, seed=seed))
    assert len(got) == 5
    for (gt, gs), (wt, ws) in zip(got, want):
        np.testing.assert_array_equal(gt, wt)
        np.testing.assert_array_equal(gs, ws)


def test_stratified_kfold_without_shuffle_and_too_many_folds():
    y = LABELS["skewed"]
    want = list(StratifiedKFold(n_splits=3, shuffle=False).split(np.zeros(len(y)), y))
    for (gt, gs), (wt, ws) in zip(stratified_kfold(y, 3, shuffle=False), want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gt, wt)
    with pytest.raises(ValueError):
        list(stratified_kfold(np.array([0, 0, 1]), 5))
