"""Plain references of the benchmark's configurations, float32 with TF32
off.  They import nothing of the program and take only what the harness
made: weights, inputs, and the program's outputs to judge."""
import torch


def strict_float32() -> None:
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
