"""Optimizer-side pieces of the port: AdamW, the cosine schedule, adaptive
gradient accumulation (the training loop's ``adaptive_accumulate``) and
its instance form (the ``gradvar`` workload), and int8 gradient
compression with error feedback (``compressed_psum`` over a worker
group)."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from .adaptive import (AdaptiveAccumConfig, adaptive_accumulate,
                       gradnorm_frame_template, make_gradnorm_sample_fn,
                       quantized_grad_norms)
from .compress import compressed_psum, dequantize_int8, quantize_int8
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "global_norm", "cosine_schedule", "AdaptiveAccumConfig",
           "adaptive_accumulate", "quantized_grad_norms",
           "gradnorm_frame_template", "make_gradnorm_sample_fn",
           "quantize_int8", "dequantize_int8", "compressed_psum"]
