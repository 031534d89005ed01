"""MQTT transport (reference: src/aiko_services/main/message/
mqtt.py:66-300).

Client selection: paho-mqtt when installed, else the in-tree
pure-stdlib client (:mod:`.mini_mqtt`) -- the MQTT control plane works
with zero third-party packages, against any broker including the
in-tree native one (:mod:`.broker`).  This is the inter-host control
plane only -- bulk tensor traffic never crosses MQTT in this framework
(it rides ICI/DCN as jax.Arrays, or the socket data plane for
host<->host hops).
"""

from __future__ import annotations

import threading

from .message import Message, MessageState
from ..utils import get_logger, get_mqtt_configuration

__all__ = ["MQTTMessage", "mqtt_available"]

_logger = get_logger("aiko.mqtt")

try:
    import paho.mqtt.client as _paho          # type: ignore
    _PAHO = True
except ImportError:
    _paho = None
    _PAHO = False


def mqtt_available() -> bool:
    return True                               # mini_mqtt is always there


def _make_client():
    if _PAHO:
        return _paho.Client(
            _paho.CallbackAPIVersion.VERSION2
            if hasattr(_paho, "CallbackAPIVersion") else None)
    from .mini_mqtt import Client
    return Client()


class MQTTMessage(Message):
    CONNECT_TIMEOUT = 5.0

    def __init__(self, message_handler=None, topics_subscribe=None,
                 lwt_topic=None, lwt_payload=None, lwt_retain=False,
                 configuration: dict | None = None):
        super().__init__(message_handler, topics_subscribe,
                         lwt_topic, lwt_payload, lwt_retain)
        # Probe: resolves through the candidate host list and fails fast
        # with a precise diagnostic when no broker answers, instead of a
        # slow paho connect timeout against a wrong AIKO_MQTT_HOST.
        self._config = configuration or get_mqtt_configuration(probe=True)
        if self._config.get("server_up") is False:
            _logger.warning(
                "no MQTT broker reachable (tried AIKO_MQTT_HOST / "
                "AIKO_MQTT_HOSTS / localhost); connecting to %s:%s anyway",
                self._config["host"], self._config["port"])
        self._connected_event = threading.Event()
        self._client = _make_client()
        self._client.on_connect = self._on_connect
        self._client.on_disconnect = self._on_disconnect
        self._client.on_message = self._on_message

    def connect(self):
        topic, payload, retain = self._lwt
        if topic:
            self._client.will_set(topic, payload, retain=retain)
        if self._config.get("username"):
            self._client.username_pw_set(self._config["username"],
                                         self._config.get("password"))
        if self._config.get("tls"):
            self._client.tls_set()
        self._client.connect_async(self._config["host"], self._config["port"])
        self._client.loop_start()
        if not self._connected_event.wait(self.CONNECT_TIMEOUT):
            _logger.warning("MQTT connect timeout to %s:%s",
                            self._config["host"], self._config["port"])

    def disconnect(self, send_will: bool = False):
        if send_will:
            topic, payload, retain = self._lwt
            if topic:
                self._client.publish(topic, payload, retain=retain)
        self._client.loop_stop()
        self._client.disconnect()
        self._set_state(MessageState.DISCONNECTED)

    def publish(self, topic, payload, retain=False, wait=False):
        info = self._client.publish(topic, payload, retain=retain)
        if wait:
            info.wait_for_publish(timeout=2.0)

    def subscribe(self, topic):
        self._subscriptions.add(topic)
        if self.state == MessageState.CONNECTED:
            self._client.subscribe(topic)

    def unsubscribe(self, topic):
        self._subscriptions.discard(topic)
        if self.state == MessageState.CONNECTED:
            self._client.unsubscribe(topic)

    def add_will(self, name, topic, payload, retain=False):
        super().add_will(name, topic, payload, retain)
        # One will per MQTT connection: the newest addition becomes the
        # connection will (reference-equivalent behavior).
        self.set_last_will_and_testament(topic, payload, retain)

    def set_last_will_and_testament(self, topic, payload, retain=False):
        # paho requires will_set before connect: cycle the connection,
        # same constraint as the reference (mqtt.py:207-213).
        was_connected = self.state == MessageState.CONNECTED
        if was_connected:
            self.disconnect()
            self._connected_event.clear()
        super().set_last_will_and_testament(topic, payload, retain)
        if was_connected:
            self.connect()

    # -- paho callbacks (network thread) -----------------------------------

    def _on_connect(self, client, userdata, *args):
        for topic in list(self._subscriptions):
            client.subscribe(topic)
        self._connected_event.set()
        self._set_state(MessageState.CONNECTED)

    def _on_disconnect(self, client, userdata, *args):
        self._set_state(MessageState.DISCONNECTED)

    def _on_message(self, client, userdata, message):
        if self._message_handler is None:
            return
        try:
            payload = message.payload.decode("utf-8")
        except UnicodeDecodeError:
            payload = message.payload
        self._message_handler(message.topic, payload)
