from .stream import (Stream, Frame, StreamEvent, StreamState,
                     DEFAULT_STREAM_ID, FIRST_FRAME_ID)
from .definition import (PipelineDefinition, ElementDefinition,
                         DefinitionError, parse_pipeline_definition,
                         load_pipeline_definition)
from .element import PipelineElement, PipelineElementLoop, ElementContext
from .pipeline import Pipeline, RemoteStage, PROTOCOL_PIPELINE, \
    create_pipeline
from .scheme import DataScheme, DataSource, DataTarget, contains_all
from .codec import (encode_frame_data, decode_frame_data, encode_value,
                    decode_value)
from .journal import (StreamJournal, JournalState, load_journal,
                      claim_adoption, adopter_of)
from .overlap import TransferLedger, DeviceWindow, device_leaves
from .fusion import (DeviceFn, FusedSegment, FusionError, FUSE_MODES,
                     setup_compilation_cache)
from .tensor import (TPUElement, JitCache, ShapeBucketer, StagePlacement,
                     encode_array, decode_array, tree_device_put)
