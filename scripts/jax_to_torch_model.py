"""Convert a JAX U-Net model file to the PyTorch port's format.

Reads a file written by ``ich_tpu``'s ``UNet2D.save_model`` (flax msgpack of
``{"params": ..., "batch_stats": ...}``) and writes the ``state_dict`` that
``ich_tpu_torch``'s ``UNet2D.load_model`` reads, so a model trained with
``ich_tpu`` can be served by ``python -m ich_tpu_torch.serve``. Runs where
JAX (flax) and PyTorch are both installed::

    python scripts/jax_to_torch_model.py model.bin model.pt
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import flax.serialization  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ich_tpu_torch.interop.from_jax import unet_state_dict_from_jax  # noqa: E402
from ich_tpu_torch.train.checkpoint import save_params  # noqa: E402


def convert(jax_model_fn: str, torch_model_fn: str) -> dict:
    """Convert one file; returns the written ``state_dict``."""
    with open(jax_model_fn, "rb") as f:
        variables = flax.serialization.msgpack_restore(f.read())
    sd = {k: torch.from_numpy(np.array(v)) for k, v in unet_state_dict_from_jax(variables).items()}
    save_params(torch_model_fn, sd)
    return sd


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("jax_model", help="input: ich_tpu save_model file")
    p.add_argument("torch_model", help="output: ich_tpu_torch state_dict (.pt)")
    args = p.parse_args(argv)
    sd = convert(args.jax_model, args.torch_model)
    print(f"{args.jax_model} -> {args.torch_model} ({len(sd)} tensors)")


if __name__ == "__main__":
    main()
