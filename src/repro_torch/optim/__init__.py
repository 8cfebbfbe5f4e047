"""Optimizer-side pieces of the port.  So far only the instance form of
adaptive gradient accumulation (the ``gradvar`` workload); the training
loop (``adaptive_accumulate``) comes with the model zoo."""
from .adaptive import (gradnorm_frame_template, make_gradnorm_sample_fn,
                       quantized_grad_norms)

__all__ = ["quantized_grad_norms", "gradnorm_frame_template",
           "make_gradnorm_sample_fn"]
