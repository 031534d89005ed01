from .service import (Service, ServiceRecord, ServiceFilter, ServiceTags,
                      ServiceRegistry, SERVICE_PROTOCOL_PREFIX)
from .actor import Actor, ActorMessage
from .share import (ECProducer, ECConsumer, ServicesCache,
                    services_cache_singleton, reset_services_cache,
                    EC_LEASE_TIME_DEFAULT)
from .registrar import Registrar, REGISTRAR_PROTOCOL
from .discovery import (RemoteProxy, ServiceDiscovery, get_service_proxy,
                        do_discovery, do_command, do_request)
from .recorder import Recorder, PROTOCOL_RECORDER
from .storage import Storage, PROTOCOL_STORAGE
