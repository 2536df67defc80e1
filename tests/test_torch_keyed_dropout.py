"""Dropout's masks are the JAX package's: the port's keyed dropout against
``ich_tpu`` and flax on the CPU, at a small size (d3 f4, 32^2 slices).

- ``philox_bits`` (host and device routes) equal ``jax.random.bits`` on
  ``rbg`` keys: flat and 2-D shapes, offsets into the stream, a key whose
  counter crosses 2^64;
- each Dropout's flax path and key, found by intercepting flax's
  ``nn.Dropout`` in the JAX nets (plain, remat, encoder, partial, gated),
  and its output on the same input equal (``array_equal``);
- ``keyed_dropout_plain`` equal to ``nn.Dropout`` in float32 and bfloat16
  (flax divides a bf16 input by the keep rate rounded to bf16; so does the
  port), the autograd backward the same function of the gradient;
- a ``ConvBlock`` and a U-Net train-mode forward at dropout 0.5 against
  ``ich_tpu``'s (outputs rtol 1e-5, every mask ``array_equal``);
- remat's gradients ``torch.equal`` to the plain net's with dropout on;
- the known answers that ``chip_smoke.py`` phase 16 holds the card's
  kernel to, recomputed with JAX.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax.core.scope import _fold_in_static

from ich_tpu.models import PartialUNet as JaxPartialUNet
from ich_tpu.models import UNet as JaxUNet
from ich_tpu.models import UNetEncoder as JaxUNetEncoder
from ich_tpu.models.layers import ConvBlock as JaxConvBlock
from ich_tpu.utils.rng import dropout_key
from ich_tpu_torch.interop.from_jax import (
    _Emitter,
    partial_unet_state_dict_from_jax,
    unet_encoder_state_dict_from_jax,
    unet_state_dict_from_jax,
)
from ich_tpu_torch.models.init import flax_fold
from ich_tpu_torch.models.layers import ConvBlock, Dropout, set_dropout_keys
from ich_tpu_torch.models.unet import PartialUNet, UNet, UNetEncoder
from ich_tpu_torch.ops import dropout
from ich_tpu_torch.utils import rng

torch.set_num_threads(2)

SEED = 5
NET = dict(depth=3, top_filter=4, midchannels_factor=2)


def _jax_words(key) -> list:
    return [int(w) for w in np.asarray(jax.random.key_data(key))]


def _rbg(words):
    return jax.random.wrap_key_data(jnp.asarray(words, jnp.uint32), impl="rbg")


# -- the stream ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 3, 4, 5, 1000, 2**16 + 3])
def test_philox_bits_equal_jax(n):
    """Both routes, from the start of the stream and from offsets 1, 4 and
    6 (the JAX draw of ``n + offset`` words, sliced), and a 2-D draw."""
    k = dropout_key(jax.random.PRNGKey(n))
    key = rng.rbg_key(rng.prng_key(n))
    assert list(key) == _jax_words(k)
    want = np.asarray(jax.random.bits(k, (n + 6,), jnp.uint32)).astype(np.int64)
    for off in (0, 1, 4, 6):
        host = rng.philox_bits(key, n, off).numpy()
        blocks = rng._philox_device(key, off // 4, (off + n + 3) // 4 - off // 4, "cpu")
        dev = blocks.reshape(-1)[off % 4:off % 4 + n].numpy()
        np.testing.assert_array_equal(host, want[off:off + n], err_msg=f"host, offset {off}")
        np.testing.assert_array_equal(dev, want[off:off + n], err_msg=f"device, offset {off}")
    rows = max(1, n // 7)
    want2 = np.asarray(jax.random.bits(k, (rows, 7), jnp.uint32)).astype(np.int64).ravel()
    np.testing.assert_array_equal(rng.philox_bits(key, rows * 7).numpy(), want2)


@pytest.mark.parametrize("low", [0xFFFFFFF0, 0xFFFFFFFF])
def test_philox_counter_crosses_2_64(low):
    """A key whose 64-bit low counter half wraps within the draw: the carry
    runs into the high half, as XLA's 128-bit counter does."""
    key = (7, 9, low, 0xFFFFFFFF)
    want = np.asarray(jax.random.bits(_rbg(key), (3, 37), jnp.uint32)).astype(np.int64).ravel()
    np.testing.assert_array_equal(rng.philox_bits(key, 111).numpy(), want)
    dev = rng._philox_device(key, 0, 28, "cpu").reshape(-1)[:111].numpy()
    np.testing.assert_array_equal(dev, want)


def test_rbg_fold_in_is_flaxs_static_fold():
    """flax folds a Dropout's path and counter into the ``rbg`` key with
    ``_fold_in_static``; the port's ``rbg_fold_in`` of ``flax_fold``
    equals it, for paths of one to four names."""
    k = dropout_key(jax.random.PRNGKey(SEED))
    key = rng.rbg_key(rng.prng_key(SEED))
    for path in (("Dropout_0",), ("encoder", "down_0", "Dropout_0"),
                 ("model", "encoder", "bottleneck", "Dropout_0")):
        want = _jax_words(_fold_in_static(k, path + (1,)))
        assert list(rng.rbg_fold_in(key, flax_fold(path, 1))) == want, path


# -- the op --------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rate", [0.1, 0.3, 0.5])
@pytest.mark.parametrize("shape", [(2, 8, 8, 6), (3, 5, 7, 9), (2, 4, 6, 6, 8)])
def test_keyed_dropout_plain_equals_flax(shape, rate, dtype):
    """Channels-last ``shape`` through flax's ``nn.Dropout`` and the port's
    channels-first op from the same key, at offset 0 and at a rank's
    offset (rows 1.. of a batch of one more): ``array_equal``."""
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    k = _fold_in_static(dropout_key(jax.random.PRNGKey(SEED)), ("Dropout_0", 1))
    key = (*rng.prng_key(SEED).tolist(), flax_fold(("Dropout_0",), 1))
    assert list(dropout.flax_dropout_key(key)) == _jax_words(k)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    xj = jnp.concatenate([jnp.zeros((1,) + shape[1:]), jnp.asarray(x)]).astype(jdt)
    want = np.asarray(fnn.Dropout(rate, deterministic=False).apply({}, xj, rng=k)
                      .astype(jnp.float32))
    xt = torch.from_numpy(x).to(tdt).movedim(-1, 1)
    per_row = int(np.prod(shape[1:]))
    for off, rows in ((0, slice(0, 1)), (per_row, slice(1, None))):
        xr = xt if off else torch.zeros_like(xt[:1])
        got = dropout.keyed_dropout_plain(xr, key, rate, off).movedim(1, -1).float().numpy()
        np.testing.assert_array_equal(got, want[rows], err_msg=f"offset {off}")


def test_keyed_dropout_backward_is_the_same_mask():
    """The gradient of ``keyed_dropout`` is the function applied to the
    gradient, and it is flax's: ``jax.vjp`` of ``nn.Dropout``."""
    rs = np.random.default_rng(1)
    x, g = (rs.standard_normal((2, 6, 6, 5)).astype(np.float32) for _ in range(2))
    k = _fold_in_static(dropout_key(jax.random.PRNGKey(SEED)), ("Dropout_0", 1))
    _, vjp = jax.vjp(lambda a: fnn.Dropout(0.3, deterministic=False).apply({}, a, rng=k),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).movedim(-1, 1).requires_grad_()
    key = (*rng.prng_key(SEED).tolist(), flax_fold(("Dropout_0",), 1))
    dropout.keyed_dropout(xt, key, 0.3).backward(torch.from_numpy(g).movedim(-1, 1))
    np.testing.assert_array_equal(xt.grad.movedim(1, -1).numpy(), want)


def test_keyed_dropout_rejects_what_the_kernel_does_not_take():
    key = (1, 2, 3)
    with pytest.raises(ValueError):
        dropout.keyed_dropout(torch.zeros(2, 3, 4, dtype=torch.float64), key, 0.5)
    with pytest.raises(ValueError):
        dropout.keyed_dropout(torch.zeros(4), key, 0.5)
    with pytest.raises(ValueError):
        dropout.keyed_dropout(torch.zeros(2, 3, 4), (1, 2, 3, 4), 0.5)
    # neither CPU nor CUDA: no silent route to the plain version
    with pytest.raises(ValueError):
        dropout.keyed_dropout(torch.zeros(2, 3, 4, device="meta"), key, 0.5)
    x = torch.ones(2, 3, 4)
    assert dropout.keyed_dropout(x, key, 0.0) is x
    assert torch.equal(dropout.keyed_dropout(x, key, 1.0), torch.zeros_like(x))


# -- the nets -----------------------------------------------------------------------


def _intercepted(net, variables, x, key):
    """flax's train-mode apply of ``net`` with ``rngs={"dropout":
    dropout_key(key)}``; each Dropout's (scope path, input, keep mask). The
    interceptor calls the Dropout once, on ones, and rebuilds its output
    from the mask as flax does, so the net computes what it would."""
    seen = []

    def icpt(next_fun, args, kwargs, ctx):
        if not (isinstance(ctx.module, fnn.Dropout) and ctx.method_name == "__call__"):
            return next_fun(*args, **kwargs)
        a = args[0]
        ones = next_fun(jnp.ones_like(a), *args[1:], **kwargs)
        keep = ones != 0
        if isinstance(a, jax.core.Tracer):  # under nn.remat: the path alone
            seen.append((ctx.module.scope.path, None, None))
        else:
            seen.append((ctx.module.scope.path, np.asarray(a, np.float32), np.asarray(keep)))
        return jax.lax.select(keep, a / jnp.asarray(1.0 - ctx.module.rate, a.dtype),
                              jnp.zeros_like(a))

    with fnn.intercept_methods(icpt):
        out, _ = net.apply(variables, x, train=True, rngs={"dropout": dropout_key(key)},
                           mutable=["batch_stats"])
    return out, seen


def _jax_and_port(kind):
    """(JAX net, port net with the JAX net's weights, channels)."""
    in_ch = 2 if kind == "gated" else 1
    j_kw = dict(p_dropout=0.5, **NET)
    if kind == "encoder":
        jnet, convert = JaxUNetEncoder(mlp_head=(8, 4), **j_kw), unet_encoder_state_dict_from_jax
        pnet = UNetEncoder(mlp_head=(8, 4), **j_kw)
    elif kind == "partial":
        jnet = JaxPartialUNet(n_decoder=1, head_channel=(8, 4), **j_kw)
        convert = partial_unet_state_dict_from_jax
        pnet = PartialUNet(n_decoder=1, head_channel=(8, 4), **j_kw)
    else:
        flags = {"remat": kind == "remat", "gated": kind == "gated"}
        jnet, convert = JaxUNet(**flags, **j_kw), unet_state_dict_from_jax
        pnet = UNet(in_channels=in_ch, **flags, **j_kw)
    x = np.random.default_rng(0).uniform(size=(4, 32, 32, in_ch)).astype(np.float32)
    key = jax.random.PRNGKey(SEED)
    v = jax.tree_util.tree_map(np.asarray, jnet.init({"params": key, "dropout": key}, x))
    pnet.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in convert(v).items()})
    return jnet, v, pnet.train(), x


@pytest.mark.parametrize("kind", ["unet", "remat", "encoder", "partial", "gated"])
def test_each_dropout_has_flaxs_path_and_key(kind):
    """The walk gives every port Dropout its flax scope path; on the JAX
    net's input at that Dropout the port's keyed op gives flax's mask and
    output (under ``nn.remat`` flax traces: the paths alone there); the
    nets' train-mode outputs within 1e-4 (float rounding through the batch
    statistics of a batch of 4; another mask moves them by far more)."""
    jnet, v, pnet, x = _jax_and_port(kind)
    want, seen = _intercepted(jnet, v, x, jax.random.PRNGKey(SEED + 1))
    set_dropout_keys(pnet, rng.prng_key(SEED + 1))
    drops = {m.flax_path: m for m in pnet.modules() if isinstance(m, Dropout)}
    assert sorted(drops) == sorted(p for p, _, _ in seen) and len(seen) == 3
    for path, a, keep in seen:
        if a is None:
            continue
        got = drops[path](torch.tensor(a).movedim(-1, 1)).movedim(1, -1).numpy()
        np.testing.assert_array_equal(got, np.where(keep, a / np.float32(0.5), 0.0),
                                      err_msg=str(path))
    got = pnet(torch.from_numpy(x).movedim(-1, 1))
    got = (got if got.dim() == 2 else got.movedim(1, -1)).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_conv_block_train_forward_matches_jax():
    """One ``ConvBlock`` (BatchNorm, dropout 0.5) applied alone: its
    Dropout's scope is ``Dropout_0`` under the root; output within rtol
    1e-5 and atol 3e-5 (1e-5 of its scale: float rounding of the batch
    statistics), and zero where flax's is."""
    x = np.random.default_rng(2).uniform(size=(4, 16, 16, 3)).astype(np.float32)
    jblk = JaxConvBlock(out_channels=8, mid_channels=4, p_dropout=0.5)
    key = jax.random.PRNGKey(SEED)
    v = jax.tree_util.tree_map(np.asarray, jblk.init({"params": key, "dropout": key}, x))
    want, _ = jblk.apply(v, x, train=True, rngs={"dropout": dropout_key(key)},
                         mutable=["batch_stats"])
    e = _Emitter({"params": {"b": v["params"]}, "batch_stats": {"b": v["batch_stats"]}})
    e.block("b", "b")
    blk = ConvBlock(3, 8, 4, p_dropout=0.5).train()
    blk.load_state_dict({k[2:]: torch.from_numpy(np.array(a)) for k, a in e.sd.items()})
    blk.dropout.flax_path = ("Dropout_0",)
    blk.dropout.fold = flax_fold(blk.dropout.flax_path, 1)
    set_dropout_keys(blk, rng.prng_key(SEED))
    got = blk(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=3e-5)
    np.testing.assert_array_equal(got == 0, np.asarray(want) == 0)


def test_unet_train_forward_matches_jax():
    """The 2.5D U-Net at dropout 0.5 in train mode: every Dropout's mask
    ``array_equal`` to flax's (the port's recomputed on ones with its key
    and offset) and the output within rtol 1e-5."""
    jnet, v, pnet, x = _jax_and_port("unet")
    want, seen = _intercepted(jnet, v, x, jax.random.PRNGKey(SEED + 2))
    masks = {}

    def hook(m, args, y):
        ones = torch.ones_like(args[0])
        masks[m.flax_path] = dropout.keyed_dropout_plain(ones, (*m.key, m.fold), m.p, 0) != 0

    for m in pnet.modules():
        if isinstance(m, Dropout):
            m.register_forward_hook(hook)
    set_dropout_keys(pnet, rng.prng_key(SEED + 2))
    got = pnet(torch.from_numpy(x).movedim(-1, 1)).movedim(1, -1).detach().numpy()
    for path, _, keep in seen:
        np.testing.assert_array_equal(masks[path].movedim(1, -1).numpy(), keep, err_msg=str(path))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("norm", ["batch", "group"])
def test_remat_gradients_equal_plain_with_dropout(norm):
    """``remat=True`` at dropout 0.5: the recompute draws the same masks,
    so every gradient and running statistic is ``torch.equal`` to the plain
    net's."""
    x = torch.from_numpy(np.random.default_rng(3).uniform(size=(2, 1, 32, 32))
                         .astype(np.float32))
    nets = {}
    for remat in (False, True):
        net = UNet(norm=norm, p_dropout=0.5, remat=remat, key=rng.prng_key(SEED), **NET).train()
        set_dropout_keys(net, rng.prng_key(SEED + 3))
        net(x).square().mean().backward()
        nets[remat] = net
    for (k, a), b in zip(nets[False].named_parameters(), nets[True].parameters()):
        assert torch.equal(a.grad, b.grad), k
    for (k, a), b in zip(nets[False].named_buffers(), nets[True].buffers()):
        assert torch.equal(a, b), k


def test_the_chip_dropout_constants_are_jaxs():
    """``chip_smoke.py`` phase 16 holds the card's kernel to these:
    recomputed here with flax, they must equal what the script carries."""
    import chip_smoke as cs

    k = _fold_in_static(dropout_key(jax.random.PRNGKey(cs.DROPOUT_SEED)),
                        cs.DROPOUT_PATH + (1,))
    assert cs.DROPOUT_KNOWN["key"] == _jax_words(k)
    assert cs.DROPOUT_KNOWN["key"] == list(dropout.flax_dropout_key(cs.dropout_known_key()))
    for name, dt, shape, rate, off in cs.DROPOUT_CASES:
        v = cs.dropout_input(shape)
        xin = jnp.concatenate([jnp.zeros(off, jnp.float32), jnp.asarray(v)]).astype(dt)[None]
        y = fnn.Dropout(rate, deterministic=False).apply({}, xin, rng=k)
        y = np.asarray(y.astype(jnp.float32))[0, off:].astype(np.float64)
        assert cs.DROPOUT_KNOWN[name] == cs.dropout_answers(y), name
        # the script's own check passes on the plain version here
        got = dropout.keyed_dropout_plain(cs.dropout_tensor(v, shape, getattr(torch, dt)),
                                          cs.dropout_known_key(), rate, off)
        assert cs.dropout_answers(got.movedim(1, -1).reshape(-1)) == cs.DROPOUT_KNOWN[name]
