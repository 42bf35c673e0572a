from .compression import (compress_int8, decompress_int8,
                          error_feedback_allreduce, init_residuals)
from .optimizers import (Optimizer, OptState, adafactor, adamw,
                         clip_by_global_norm, cosine_schedule)
from .quantized_state import QTensor, dequantize_blockwise, quantize_blockwise

__all__ = ["adamw", "adafactor", "Optimizer", "OptState", "clip_by_global_norm",
           "cosine_schedule", "QTensor", "quantize_blockwise", "dequantize_blockwise",
           "compress_int8", "decompress_int8", "error_feedback_allreduce",
           "init_residuals"]
