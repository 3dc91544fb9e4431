"""tpu_ffv1 — an FFV1 video codec framework with a JAX device pipeline.

Bit-exact FFV1 (versions 0-4, range & Golomb-Rice coders, GOP/P-frame
context carry-over) with three interchangeable execution paths:

  * spec:   pure-Python scalar oracle (tpu_ffv1.codec)
  * native: C host runtime for production host encode/decode (native/)
  * tpu:    JAX/XLA device pipeline with CUDA range-coder scans
            (tpu_ffv1.tpu)

Heavy submodules (jax-backed device classes) load lazily so importing
the host codec never initializes an accelerator.
"""

from .codec.decoder import FFV1Decoder
from .codec.encoder import FFV1Encoder
from .codec.params import EncoderParams

__all__ = ["EncoderParams", "FFV1Encoder", "FFV1Decoder",
           "TPUFFV1Encoder", "TPUFFV1Decoder",
           "FFV1PEncoder", "FFV1PDecoder",
           "TPUFFV1PEncoder", "TPUFFV1PDecoder"]
__version__ = "0.3.0"

_LAZY = {
    "TPUFFV1Encoder": ("tpu_ffv1.tpu.encoder", "TPUFFV1Encoder"),
    "TPUFFV1Decoder": ("tpu_ffv1.tpu.decoder", "TPUFFV1Decoder"),
    "FFV1PEncoder": ("tpu_ffv1.pframe.codec", "FFV1PEncoder"),
    "FFV1PDecoder": ("tpu_ffv1.pframe.codec", "FFV1PDecoder"),
    "TPUFFV1PEncoder": ("tpu_ffv1.pframe.tpu", "TPUFFV1PEncoder"),
    "TPUFFV1PDecoder": ("tpu_ffv1.pframe.tpu", "TPUFFV1PDecoder"),
}


def __getattr__(name):
    if name in _LAZY:
        import importlib
        mod, attr = _LAZY[name]
        return getattr(importlib.import_module(mod), attr)
    raise AttributeError(f"module 'tpu_ffv1' has no attribute {name!r}")
