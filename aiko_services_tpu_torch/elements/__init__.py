"""Pipeline elements of the PyTorch port: the JAX package's element
library, plus ``Increment`` and ``DetectionCaption`` exported here."""

from .common import Mock, NoOp, Identity, Increment, Terminate
from .scheme_file import DataSchemeFile
from .scheme_zmq import (DataSchemeZMQ, TextReadZMQ, TextWriteZMQ,
                         ImageReadZMQ, ImageWriteZMQ)
from .scheme_tty import DataSchemeTTY, TextReadTTY, TextWriteTTY
from .text import (TextReadFile, TextWriteFile, TextTransform, TextSample,
                   TextFilter, TextOutput)
from .image import (ImageReadFile, ImageWriteFile, ImageResize,
                    ImageOverlay, ImageOutput, image_to_array,
                    array_to_image)
from .video import (VideoReadFile, VideoWriteFile, VideoSample,
                    VideoOutput, VideoReadWebcam)
from .audio import (AudioReadFile, AudioWriteFile, AudioFraming,
                    AudioResampler, AudioFFT, AudioGraphXY, AudioOutput,
                    read_wav, write_wav)
from .audio_live import (MicrophoneRead, SpeakerWrite, DataSchemeMic,
                         DataSchemeSpeaker)
from .scheme_rtsp import DataSchemeRTSP, VideoReadRTSP, VideoWriteRTSP
from .scheme_tensor import (DataSchemeTensorPipe, TensorReadPipe,
                            TensorWritePipe)
from .detect import Detector
from .vision import FaceDetect, ArucoMarkerDetect
from .llm import LLM, LLMService, DetectionCaption, PROTOCOL_LLM
from .speech import ASR, TTS
from .observe import Inspect, Metrics
from .expression import Expression, AllOutputs, evaluate_expression
from .control import Loop
