"""The benchmark of stark_anatomy_tpu_torch, the PyTorch and CUDA port, on
NVIDIA H100 cards: ``python3 portbench/run.py --workload <cell> --seed
<n> --seconds <s> --trace <0|1>`` (see run.py and harness.py)."""
