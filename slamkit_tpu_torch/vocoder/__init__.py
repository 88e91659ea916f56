from .audio_vocoder import AudioVocoder, vocoder_factory
from .hifi_gan_vocoder import HiFiGANVocoder

__all__ = ["AudioVocoder", "vocoder_factory", "HiFiGANVocoder"]
