from .event import EventEngine
from .connection import Connection, ConnectionState
from .lease import Lease
from .hooks import Hook, Hooks, default_hook_handler
from .process import (ProcessRuntime, process, init_process, reset_process,
                      REGISTRAR_BOOT_VERSION)
