"""The benchmark of quantumcomputer_tpu_torch on one or more CUDA cards: ``python3 portbench/run.py --help``."""
