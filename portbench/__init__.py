"""The benchmark of ``ich_tpu_torch``, the PyTorch and CUDA port, on NVIDIA
cards: ``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` (see ``portbench/README.md``)."""
