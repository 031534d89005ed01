from .sexpr import generate, generate_value, parse, parse_value, \
    parse_bool, parse_number, parse_to_dict, SExprError
from .graph import Graph, Node, GraphError
from .configuration import (
    get_namespace, get_hostname, get_pid, get_username, get_transport,
    get_mqtt_configuration, get_mqtt_host, mqtt_broker_reachable,
    bootstrap_start, bootstrap_discover, BOOTSTRAP_UDP_PORT,
    env_flag, env_int, env_float)
from .logger import get_logger, TransportLogHandler, RateLimiter
from .misc import (LRUCache, load_module, load_class, find_free_port,
                   utc_iso8601, epoch_to_iso8601, process_memory_rss,
                   next_power_of_two)
from .trace import MethodTrace, trace_methods, record_calls
