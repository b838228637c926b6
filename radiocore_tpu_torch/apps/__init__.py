"""Application layer of the port (mirrors ``radiocore_tpu.apps``):
receiver apps and IQ sources/sinks.

``receive_fm`` (single station), ``multi_fm_server`` (channelize + demod
+ ZMQ PUB) and ``multi_fm_receiver`` (ZMQ SUB + audio out), each run as
``python -m radiocore_tpu_torch.apps.<name>``; they run on the first CUDA
device unless ``--device`` names another. Hardware edges are pluggable:
SoapySDR and sounddevice are optional; synthetic and file IQ sources
plus WAV sinks make every app runnable headless.
"""

from radiocore_tpu_torch.apps.iq import (AudioDeviceSink, IQFileSource,
                                         SoapySdrSource, SyntheticFmSource,
                                         WavSink, write_iq_file)

__all__ = ["SyntheticFmSource", "IQFileSource", "SoapySdrSource",
           "AudioDeviceSink", "WavSink", "write_iq_file"]
