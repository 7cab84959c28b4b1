"""The benchmark of the PyTorch/CUDA port (intrinsic_neural_fields_tpu_torch):
``python -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``."""
