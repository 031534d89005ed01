from .message import Message, MessageState, topic_matches
from .castaway import CastawayMessage
from .loopback import (LoopbackBroker, LoopbackMessage, get_broker,
                       reset_broker)
from .mqtt import MQTTMessage, mqtt_available
from .broker import BrokerProcess, broker_binary


def create_transport(kind: str, **kwargs) -> Message:
    if kind == "loopback":
        return LoopbackMessage(**kwargs)
    if kind == "castaway":
        return CastawayMessage(**kwargs)
    if kind == "mqtt":
        return MQTTMessage(**kwargs)
    raise ValueError(f"unknown transport: {kind}")
