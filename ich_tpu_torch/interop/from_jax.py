"""Convert the JAX package's U-Net family, ResNet, SN-PatchGAN, autoencoder
and FCDD variables to port ``state_dict``s.

The inverse of ``ich_tpu.interop.torch_port``'s ``port_unet``,
``port_unet_encoder``, ``port_partial_unet`` and ``port_resnet``: flax
variables ``{"params": ..., "batch_stats": ...}`` of
:class:`ich_tpu.models.UNet`, ``UNetEncoder``, ``PartialUNet`` or
``ResNet``, as plain numpy nests, become ``{torch key: numpy array}`` for
their counterparts in :mod:`ich_tpu_torch.models.unet` and
:mod:`ich_tpu_torch.models.resnet`; the generators and the discriminator of
:mod:`ich_tpu.models.inpainting` likewise for
:mod:`ich_tpu_torch.models.inpainting` (with the discriminator's
``spectral_stats`` as the ``u`` and ``sigma`` buffers); ``AENet`` and
``FCDD_CNN_VGG`` for :mod:`ich_tpu_torch.models.ae` and
:mod:`ich_tpu_torch.models.fcdd`. A gated U-Net (``UNet(gated=True)``)
converts as any U-Net: each of its convs emits ``2 ch`` channels, the
features first, in both packages, under the same keys. Layouts converted:

- conv kernels: flax HWIO / DHWIO -> torch OIHW / OIDHW;
- transposed-conv kernels: flax ``(*k, I, O)`` -> torch ``(I, O, *k)``, with
  the spatial axes flipped back (flax's ``ConvTranspose`` correlates, torch
  computes the conv adjoint);
- BatchNorm: ``scale``/``bias`` and ``batch_stats`` ``mean``/``var`` ->
  ``weight``/``bias``/``running_mean``/``running_var``; GroupNorm: ``scale``/
  ``bias`` -> ``weight``/``bias``; a net with ``norm="none"`` has no norm
  variables and gets no norm keys;
- Dense kernels: flax ``(I, O)`` -> torch ``(O, I)``.

No JAX import: the inputs are numpy mappings. The walks that map one
layout to the other also serve :func:`ich_tpu_torch.models.init.init_like_flax`,
which also gives each Dropout its flax scope path through them.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping

import numpy as np
import torch

Array = np.ndarray


def _conv_perm(nsp: int):
    return (nsp + 1, nsp) + tuple(range(nsp))


def _convt_perm(nsp: int):
    return (nsp, nsp + 1) + tuple(range(nsp))


def conv_weight(kernel):
    """flax ``*k I O`` -> torch ``O I *k`` (a numpy array or a tensor)."""
    if isinstance(kernel, torch.Tensor):
        return kernel.permute(_conv_perm(kernel.dim() - 2)).contiguous()
    k = np.asarray(kernel)
    return np.ascontiguousarray(np.transpose(k, _conv_perm(k.ndim - 2)))


def convt_weight(kernel):
    """flax ConvTranspose ``*k I O`` -> torch ``I O *k``, spatially flipped
    (a numpy array or a tensor)."""
    if isinstance(kernel, torch.Tensor):
        nsp = kernel.dim() - 2
        return kernel.flip(tuple(range(nsp))).permute(_convt_perm(nsp)).contiguous()
    k = np.asarray(kernel)
    nsp = k.ndim - 2
    k = np.flip(k, axis=tuple(range(nsp)))
    return np.ascontiguousarray(np.transpose(k, _convt_perm(nsp)))


conv_weight.perm = _conv_perm
convt_weight.perm = _convt_perm


class _Emitter:
    """Walks a family's flax variables and emits the port's ``state_dict``.

    The walks below ask only :meth:`exists` and :meth:`query` about the
    structure and emit through :meth:`conv`, :meth:`dense`, :meth:`norm`,
    :meth:`gamma` and :meth:`spectral`, so that
    :mod:`ich_tpu_torch.models.init` runs the same walks from a port module
    to draw flax's initial variables."""

    def __init__(self, variables: Mapping):
        self.params = variables["params"]
        self.stats = variables.get("batch_stats") or {}
        self.spectral_stats = _flat(variables.get("spectral_stats") or {})
        self.sd: Dict[str, Array] = {}

    @staticmethod
    def _get(tree: Mapping, path: str) -> Mapping:
        """The node at a flax path, or {} where there is none."""
        node = tree
        for p in path.split("/"):
            node = node.get(p, {})
        return node

    def exists(self, fpath: str, tname: str) -> bool:
        """Whether the flax module at ``fpath`` (the port's ``tname``) holds
        parameters."""
        return bool(self._get(self.params, fpath))

    def query(self, on_flax: Callable[[Mapping], object], on_port: Callable[[set], object]):
        """A structural fact read from the flax params (``on_flax``) or, by
        the init walk, from the port's ``state_dict`` keys (``on_port``)."""
        return on_flax(self.params)

    def conv(self, fpath: str, tname: str, weight=conv_weight) -> None:
        node = self._get(self.params, fpath)
        self.sd[f"{tname}.weight"] = weight(node["kernel"])
        if "bias" in node:
            self.sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def dense(self, fpath: str, tname: str) -> None:
        node = self._get(self.params, fpath)
        self.sd[f"{tname}.weight"] = np.ascontiguousarray(np.asarray(node["kernel"]).T)
        self.sd[f"{tname}.bias"] = np.asarray(node["bias"])

    def norm(self, fpath: str, tname: str) -> None:
        node = self._get(self.params, fpath)
        if not node:  # norm="none": the identity holds no variables
            return
        self.sd[f"{tname}.weight"] = np.asarray(node["scale"])
        self.sd[f"{tname}.bias"] = np.asarray(node["bias"])
        stats = self._get(self.stats, fpath)
        if not stats:  # GroupNorm: no running statistics
            return
        self.sd[f"{tname}.running_mean"] = np.asarray(stats["mean"])
        self.sd[f"{tname}.running_var"] = np.asarray(stats["var"])
        self.sd[f"{tname}.num_batches_tracked"] = np.asarray(0, dtype=np.int64)

    def dropout(self, fpath: str, tname: str) -> None:
        """A Dropout's scope (it holds no variables): nothing to convert."""

    def gamma(self, fpath: str, tname: str) -> None:
        """A self-attention's residual gate."""
        self.sd[f"{tname}.gamma"] = np.asarray(self._get(self.params, fpath)["gamma"])

    def spectral(self, fpath: str, tname: str) -> None:
        """A spectral-norm wrapper's ``u`` and ``sigma`` (``fpath`` its
        variables' prefix in ``spectral_stats``), where it has them."""
        for name in ("u", "sigma"):
            key = f"{fpath}/{name}"
            if key in self.spectral_stats:
                self.sd[f"{tname}.{name}"] = self.spectral_stats[key]

    # -- the walks' shared parts ---------------------------------------------------

    def count(self, fpath, tname) -> int:
        """How many consecutive modules ``fpath.format(i)`` exist."""
        i = 0
        while self.exists(fpath.format(i), tname.format(i)):
            i += 1
        return i

    def block(self, fprefix: str, tprefix: str) -> None:
        for i in (1, 2):
            self.conv(f"{fprefix}/conv{i}", f"{tprefix}.conv{i}")
            self.norm(f"{fprefix}/bn{i}/norm", f"{tprefix}.bn{i}")
        self.dropout(f"{fprefix}/Dropout_0", f"{tprefix}.dropout")

    def encoder(self) -> None:
        for i in range(self.count("encoder/down_{}", "down_block.{}")):
            self.block(f"encoder/down_{i}", f"down_block.{i}")
        self.block("encoder/bottleneck", "bottleneck_block")

    def decoder(self) -> None:
        for i in range(self.count("decoder/up_{}", "up_block.{}")):
            if self.exists(f"decoder/up_samp_{i}", f"up_samp.{i}"):
                self.conv(f"decoder/up_samp_{i}/convT", f"up_samp.{i}", weight=convt_weight)
            self.block(f"decoder/up_{i}", f"up_block.{i}")


def walk_unet(e: _Emitter) -> None:
    """``UNet``: depth, 2D/3D and the upsampling kind read from the tree."""
    e.encoder()
    e.decoder()
    e.conv("final_conv", "final_conv")


def walk_ae(e: _Emitter) -> None:
    """``AENet``, either decoder: a bilinear decoder's first conv has a 3x3
    kernel (the port's sits after the upsample at index 1), the
    transposed-conv decoder's a 2x2 one."""
    e.conv("encoder/in_conv", "encoder.in_conv.0")
    e.norm("encoder/in_bn", "encoder.in_conv.1")
    for i in range(e.count("encoder/conv{}", "encoder.conv_list.{}")):
        e.conv(f"encoder/conv{i}", f"encoder.conv_list.{i}.0")
        e.norm(f"encoder/bn{i}", f"encoder.conv_list.{i}.1")
    e.conv("encoder/bottleneck_conv", "encoder.bottelneck_conv.0")
    e.norm("encoder/bottleneck_bn", "encoder.bottelneck_conv.1")
    bilinear = e.query(
        lambda p: np.asarray(p["decoder"]["bottleneck_convT"]["kernel"]).shape[0] == 3,
        lambda keys: "decoder.bottelneck_conv.0.weight" not in keys)
    ci, bi = (1, 2) if bilinear else (0, 1)  # the bilinear upsample sits at 0
    weight = conv_weight if bilinear else convt_weight
    e.conv("decoder/bottleneck_convT", f"decoder.bottelneck_conv.{ci}", weight=weight)
    e.norm("decoder/bottleneck_bn", f"decoder.bottelneck_conv.{bi}")
    for i in range(e.count("decoder/convT{}", "decoder.conv_list.{}")):
        e.conv(f"decoder/convT{i}", f"decoder.conv_list.{i}.{ci}", weight=weight)
        e.norm(f"decoder/bn{i}", f"decoder.conv_list.{i}.{bi}")
    e.conv("decoder/out_conv", "decoder.out_conv.0")
    e.norm("decoder/out_bn", "decoder.out_conv.1")


# FCDD_CNN_VGG's (conv, BatchNorm) pairs in the reference's ``features``
# Sequential (ReLU and max-pool layers hold no parameters)
_FCDD_CONV_IDX = (0, 4, 8, 11, 15, 18)


def walk_fcdd(e: _Emitter) -> None:
    """``FCDD_CNN_VGG``."""
    for i, idx in enumerate(_FCDD_CONV_IDX):
        e.conv(f"conv{i}", f"features.{idx}")
        e.norm(f"bn{i}", f"features.{idx + 1}")
    e.conv("conv_final", "conv_final")


def walk_unet_encoder(e: _Emitter) -> None:
    """``UNetEncoder`` with its MLP head."""
    e.encoder()
    for i in range(e.count("mlp_head/fc{}", "mlp_head.fc_layers.{}")):
        e.dense(f"mlp_head/fc{i}", f"mlp_head.fc_layers.{i}")


def walk_resnet(e: _Emitter) -> None:
    """``ResNet``: the stem, every ``stage{s}_block{b}`` (two convs for a
    basic block, three for a bottleneck, and the downsample branch where
    there is one) and ``fc``."""
    e.conv("stem_conv", "conv1")
    e.norm("stem_bn", "bn1")
    s = 0
    while e.exists(f"stage{s}_block0", f"layer{s + 1}.0"):
        for b in range(e.count(f"stage{s}_block{{}}", f"layer{s + 1}.{{}}")):
            fname, t = f"stage{s}_block{b}", f"layer{s + 1}.{b}"
            for i in (1, 2, 3):
                if e.exists(f"{fname}/conv{i}", f"{t}.conv{i}"):
                    e.conv(f"{fname}/conv{i}", f"{t}.conv{i}")
                    e.norm(f"{fname}/bn{i}", f"{t}.bn{i}")
            if e.exists(f"{fname}/down_conv", f"{t}.shortcut.0"):
                e.conv(f"{fname}/down_conv", f"{t}.shortcut.0")
                e.norm(f"{fname}/down_bn", f"{t}.shortcut.1")
        s += 1
    e.dense("fc", "linear")


def walk_partial_unet(e: _Emitter) -> None:
    """``PartialUNet`` with its conv head."""
    e.encoder()
    e.decoder()
    for i in range(e.count("conv_head/conv{}", "final_conv.conv_layers.{}")):
        e.conv(f"conv_head/conv{i}", f"final_conv.conv_layers.{i}")


# -- SN-PatchGAN networks ----------------------------------------------------------


def _flat(tree: Mapping, prefix: str = "") -> Dict[str, Array]:
    """A nested mapping as {"a/b/c": leaf}; flax's spectral-norm keys, which
    hold slashes themselves ("conv/kernel/u"), come out the same."""
    out = {}
    for k, v in (tree or {}).items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flat(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _gated(e: _Emitter, fpath: str, tname: str) -> None:
    """A ``GatedConv2d`` (its fused 2F conv and the feature half's
    BatchNorm) or an ``UpsampleGatedConv2d`` (the same under ``gconv`` /
    ``gated_conv``)."""
    if e.exists(f"{fpath}/gconv", f"{tname}.gated_conv"):
        fpath, tname = f"{fpath}/gconv", f"{tname}.gated_conv"
    e.conv(f"{fpath}/conv", f"{tname}.conv")
    e.norm(f"{fpath}/norm", f"{tname}.norm")


def _stack(e: _Emitter, fprefix: str, tprefix: str) -> None:
    for i in range(e.count(f"{fprefix}/g{{}}", f"{tprefix}.{{}}")):
        _gated(e, f"{fprefix}/g{i}", f"{tprefix}.{i}")


def _self_attention(e: _Emitter, fpath: str, tname: str) -> None:
    for name in ("conv_f", "conv_g", "conv_h"):
        e.conv(f"{fpath}/{name}", f"{tname}.{name}")
    e.gamma(fpath, tname)


def walk_gated_generator(e: _Emitter) -> None:
    """``GatedGenerator``, the contextual branch where it has one."""
    _stack(e, "coarse", "coarse")
    _stack(e, "refine_enc", "refine_enc")
    if e.exists("refine_attn_cnn1", "refine_attention_enc.cnn1"):
        _stack(e, "refine_attn_cnn1", "refine_attention_enc.cnn1")
        _stack(e, "refine_attn_cnn2", "refine_attention_enc.cnn2")
    _stack(e, "refine_dec", "refine_dec")


def walk_sa_gated_generator(e: _Emitter) -> None:
    """``SAGatedGenerator`` (the attention under ``refine_attention.0``)."""
    _stack(e, "coarse", "coarse")
    _stack(e, "refine_enc", "refine_enc")
    _self_attention(e, "self_attention", "refine_attention.0")
    _stack(e, "refine_dec", "refine_dec")


def walk_patch_discriminator(e: _Emitter) -> None:
    """``PatchDiscriminator``, each spectral-norm layer's ``u`` and
    ``sigma`` included. With self-attention the last conv sits at
    ``layer_list.{n + 1}``, after the attention and its ReLU."""
    n = e.query(lambda p: sum(1 for k in p if k.startswith("conv")),
                lambda keys: sum(1 for k in keys
                                 if k.startswith("layer_list.") and k.endswith(".conv.weight")))
    attn = e.query(lambda p: "self_attention" in p,
                   lambda keys: any(".conv_f." in k for k in keys))
    for i in range(n):
        t = f"layer_list.{i + 2 if attn and i == n - 1 else i}"
        e.conv(f"conv{i}/conv", f"{t}.conv")
        e.norm(f"conv{i}/norm", f"{t}.norm")
        e.spectral(f"conv{i}/SpectralNorm_0/conv/kernel", t)
    if attn:
        _self_attention(e, "self_attention", f"layer_list.{n - 1}")


def _convert(walk: Callable[[_Emitter], None]) -> Callable[[Mapping], Dict[str, Array]]:
    def convert(variables: Mapping) -> Dict[str, Array]:
        e = _Emitter(variables)
        walk(e)
        return e.sd

    convert.__doc__ = (f"JAX variables -> port ``state_dict`` (numpy values) by "
                       f":func:`{walk.__name__}`.")
    return convert


unet_state_dict_from_jax = _convert(walk_unet)
ae_state_dict_from_jax = _convert(walk_ae)
fcdd_state_dict_from_jax = _convert(walk_fcdd)
unet_encoder_state_dict_from_jax = _convert(walk_unet_encoder)
resnet_state_dict_from_jax = _convert(walk_resnet)
partial_unet_state_dict_from_jax = _convert(walk_partial_unet)
gated_generator_state_dict_from_jax = _convert(walk_gated_generator)
sa_gated_generator_state_dict_from_jax = _convert(walk_sa_gated_generator)
patch_discriminator_state_dict_from_jax = _convert(walk_patch_discriminator)
