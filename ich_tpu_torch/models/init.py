"""The initial weights of the JAX package's nets, drawn without flax.

``init_like_flax(module, key)`` gives a port network the variables that
``model.init({"params": key, ...})`` gives its JAX counterpart, layouts
converted: it runs the family's walk of :mod:`ich_tpu_torch.interop.
from_jax` from the port module's side and draws each variable there:

- a conv, transposed-conv or dense kernel from flax's ``lecun_normal``
  (``truncated_normal(-2, 2) * sqrt(1 / fan_in) / 0.87962566``, the fan
  in of flax's kernel layout), in flax's layout, then converted;
- biases, BatchNorm / GroupNorm shifts and running means and the
  self-attention gate zero; scales and running variances one;
- a spectral norm's power-iteration vector ``u`` from ``normal`` and its
  ``sigma`` one; its kernel is stored divided by the spectral norm that
  one power step from ``u`` estimates, as flax's ``SpectralNorm`` leaves
  it after ``init``.

Each random variable's key is flax's (``flax/core/scope.py``,
``LazyRng.as_jax_rng`` and ``Scope.make_rng``; flax is Apache-2.0): one
``fold_in`` of the root key with the first 4 bytes, big endian, of the
SHA-1 of the scope's path names followed by its ``make_rng`` counter
(``flax_fix_rng_separator`` off, flax 0.12.3's default). Draws run on the
device of the module's parameters.

The walk also gives each :class:`ich_tpu_torch.models.layers.Dropout` the
scope path of its flax counterpart (``.../down_{i}/Dropout_0``) and the
word flax folds into the ``dropout`` collection's ``rbg`` key for it (the
same SHA-1 with the scope's first ``make_rng`` counter), and
:func:`ich_tpu_torch.models.layers.set_dropout_keys` gives it the step's
dropout key.
"""

from __future__ import annotations

import hashlib
import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn

from ich_tpu_torch.interop.from_jax import _Emitter, conv_weight
from ich_tpu_torch.models.layers import Dropout
from ich_tpu_torch.utils import rng

# stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC_STD = 0.87962566103423978


def flax_fold(path: Sequence, counter: int) -> int:
    """The uint32 that flax folds into the root key for the ``counter``-th
    ``make_rng`` of the scope at ``path`` (``_fold_in_static``)."""
    m = hashlib.sha1()
    for x in tuple(path) + (counter,):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(int(x).to_bytes((int(x).bit_length() + 7) // 8, byteorder="big"))
    return int.from_bytes(m.digest()[:4], byteorder="big")


def lecun_normal(key: torch.Tensor, shape: Sequence[int], device=None) -> torch.Tensor:
    """flax's ``lecun_normal()`` of a kernel in flax's layout (inputs on the
    second-last axis, outputs on the last)."""
    shape = tuple(int(s) for s in shape)
    fan_in = shape[-2] * (math.prod(shape) / shape[-2] / shape[-1])
    stddev = np.sqrt(np.float32(1.0 / fan_in)) / np.float32(_TRUNC_STD)
    w = rng.truncated_normal(key, -2.0, 2.0, shape, device)
    return w * torch.tensor(stddev, dtype=torch.float32, device=w.device)


class _InitEmitter(_Emitter):
    """The walks of :mod:`ich_tpu_torch.interop.from_jax` run from a port
    module: structure read from its ``state_dict`` keys, variables drawn."""

    def __init__(self, module: nn.Module, key: torch.Tensor):
        self.module = module
        self.tensors = module.state_dict(keep_vars=True)
        self.keys = set(self.tensors)
        self.key = torch.as_tensor(key)
        self.sd = {}
        self.spectral_layers = []  # normalised once their variables are set

    def exists(self, fpath: str, tname: str) -> bool:
        return any(k.startswith(tname + ".") for k in self.keys)

    def query(self, on_flax, on_port):
        return on_port(self.keys)

    def _key(self, fpath: str, counter: int) -> torch.Tensor:
        return rng.fold_in(self.key, flax_fold(fpath.split("/"), counter))

    def _fill(self, tname: str, value: float) -> None:
        if tname in self.keys:
            self.sd[tname] = torch.full_like(self.tensors[tname].detach(), value)

    def conv(self, fpath: str, tname: str, weight=conv_weight) -> None:
        w = self.tensors[f"{tname}.weight"]
        perm = weight.perm(w.dim() - 2)
        shape = [0] * w.dim()
        for j, pj in enumerate(perm):
            shape[pj] = w.shape[j]
        self.sd[f"{tname}.weight"] = weight(lecun_normal(self._key(fpath, 1), shape, w.device))
        self._fill(f"{tname}.bias", 0.0)

    def dense(self, fpath: str, tname: str) -> None:
        w = self.tensors[f"{tname}.weight"]
        kernel = lecun_normal(self._key(fpath, 1), (w.shape[1], w.shape[0]), w.device)
        self.sd[f"{tname}.weight"] = kernel.t().contiguous()
        self._fill(f"{tname}.bias", 0.0)

    def norm(self, fpath: str, tname: str) -> None:
        self._fill(f"{tname}.weight", 1.0)
        self._fill(f"{tname}.bias", 0.0)
        self._fill(f"{tname}.running_mean", 0.0)
        self._fill(f"{tname}.running_var", 1.0)
        self._fill(f"{tname}.num_batches_tracked", 0)

    def gamma(self, fpath: str, tname: str) -> None:
        self._fill(f"{tname}.gamma", 0.0)

    def dropout(self, fpath: str, tname: str) -> None:
        # a block without dropout holds an nn.Identity, as the JAX block
        # holds no Dropout scope
        m = self.module.get_submodule(tname)
        if isinstance(m, Dropout):
            m.flax_path = tuple(fpath.split("/"))
            m.fold = flax_fold(m.flax_path, 1)

    def spectral(self, fpath: str, tname: str) -> None:
        # flax's SpectralNorm draws u with the first make_rng("params") of
        # its own scope, the layer's path less "conv/kernel"
        if f"{tname}.u" not in self.keys:
            return
        u = self.tensors[f"{tname}.u"]
        scope = fpath.rsplit("/", 2)[0]
        self.sd[f"{tname}.u"] = rng.normal(self._key(scope, 1), tuple(u.shape), u.device)
        self._fill(f"{tname}.sigma", 1.0)
        self.spectral_layers.append(tname)


def init_like_flax(module: nn.Module, key: Optional[torch.Tensor] = None) -> nn.Module:
    """Overwrite ``module``'s variables with those flax's ``init`` draws for
    its JAX counterpart from ``key`` (``prng_key(0)``, the JAX trainers'
    default seed, when None); ``module`` is a network family that names its
    walk in ``_flax_walk``. Raises if a parameter is left undrawn. Returns
    ``module``."""
    e = _InitEmitter(module, rng.prng_key(0) if key is None else key)
    type(module)._flax_walk(e)
    missing = [n for n, _ in module.named_parameters() if n not in e.sd]
    if missing:
        raise ValueError(f"init_like_flax: {type(module).__name__} left {missing[:5]} undrawn")
    with torch.no_grad():
        for name, value in e.sd.items():
            e.tensors[name].copy_(value)
    for tname in e.spectral_layers:
        module.get_submodule(tname).normalize_kernel_()
    return module
