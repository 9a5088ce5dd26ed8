"""Serving graph (the reference's cc/nn/engine/ counterpart).

The reference serves search evals through a TensorRT engine built from the
exported model (trt_engine.cc: fused, BN-folded, fp16). Here that is
`serve.serve_forward`: the same weights with BatchNorm folded into the
producer convolutions and the training-only heads pruned, compiled by XLA
inside the search program.
"""
from p3achygo_tpu.nn.serve import serve_forward, serve_supported

__all__ = ["serve_forward", "serve_supported"]
