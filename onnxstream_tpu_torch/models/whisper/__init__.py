from onnxstream_tpu_torch.models.whisper.mel import log_mel_spectrogram  # noqa: F401
from onnxstream_tpu_torch.models.whisper.model import (  # noqa: F401
    WHISPER_BASE,
    WHISPER_TINY_TEST,
    WhisperConfig,
    build_decoder,
    build_encoder,
)
from onnxstream_tpu_torch.models.whisper.pipeline import WhisperPipeline  # noqa: F401
