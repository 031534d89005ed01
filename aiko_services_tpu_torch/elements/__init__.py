"""Pipeline elements of the PyTorch port: only what is ported so far
(ROADMAP Queue 1); the JAX package's other elements wait for later
slices."""

from .common import Mock, NoOp, Identity, Increment, Terminate
from .scheme_file import DataSchemeFile
from .text import (TextReadFile, TextWriteFile, TextTransform, TextSample,
                   TextFilter, TextOutput)
from .audio import (AudioReadFile, AudioWriteFile, AudioFraming,
                    AudioResampler, AudioFFT, AudioGraphXY, AudioOutput,
                    read_wav, write_wav)
from .audio_live import (MicrophoneRead, SpeakerWrite, DataSchemeMic,
                         DataSchemeSpeaker)
from .expression import Expression, AllOutputs, evaluate_expression
from .control import Loop
from .detect import Detector
from .llm import LLM, LLMService, DetectionCaption, PROTOCOL_LLM
from .speech import ASR, TTS
