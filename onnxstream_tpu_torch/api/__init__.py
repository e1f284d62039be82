"""Language API surface: the 15-function C ABI (``capi``, built into
``libonnxstream_tpu_torch.so`` from ``csrc/exports.cpp``) and its Python
bindings (``bindings``)."""
