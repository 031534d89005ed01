"""Pipeline elements of the PyTorch port: only what is ported so far
(ROADMAP Queue 1); the JAX package's other elements wait for later
slices."""

from .common import Mock, NoOp, Identity, Increment, Terminate
from .expression import Expression, AllOutputs, evaluate_expression
from .control import Loop
from .detect import Detector
from .llm import LLM, LLMService, DetectionCaption, PROTOCOL_LLM
