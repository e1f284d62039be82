"""The benchmark of onnxstream_tpu_torch on NVIDIA GPUs (``run.py``)."""
