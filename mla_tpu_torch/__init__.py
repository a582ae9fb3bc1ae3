"""PyTorch/CUDA port of mla_tpu: the M3AE classifier served on an NVIDIA
Hopper card, with the flat attention forward as a hand-written kernel."""
