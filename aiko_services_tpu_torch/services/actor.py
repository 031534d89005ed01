"""Actor: Service + ordered mailboxes + remote method invocation
(reference: src/aiko_services/main/actor.py).

Inbound ``(command arg...)`` payloads on ``topic/in`` (or ``topic/control``
for priority traffic) are parsed and queued to per-actor mailboxes on the
event engine; the mailbox handler invokes the named public method
(reference actor.py:129-176,231-254).  The control mailbox preempts the in
mailbox -- management stays responsive under data load.

Every actor exposes a ``share`` dict replicated to observers by an
:class:`ECProducer` (reference actor.py:223-229), giving dashboards and
tests a live view of ``lifecycle``/``log_level``/custom state.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from .service import Service
from .share import ECProducer
from ..utils import get_logger, parse, SExprError

__all__ = ["Actor", "ActorMessage"]

_logger = get_logger("aiko.actor")


# Public methods that must never be invocable from the wire: `run` would
# re-enter the event loop on the dispatch thread and hang the process.
_REMOTE_DENY = {"run"}


@dataclasses.dataclass
class ActorMessage:
    target: Any
    command: str
    arguments: list

    def invoke(self):
        method = getattr(self.target, self.command, None)
        if (method is None or not callable(method)
                or self.command.startswith("_")
                or self.command in _REMOTE_DENY):
            _logger.warning("%s: unknown command %r",
                            getattr(self.target, "name", "?"), self.command)
            return
        method(*self.arguments)


class Actor(Service):
    HOOK_MESSAGE_IN = "actor.message_in:0"
    HOOK_MESSAGE_CALL = "actor.message_call:0"

    def __init__(self, name: str, protocol: str, tags=None, runtime=None,
                 transport=None):
        super().__init__(name, protocol, tags=tags, runtime=runtime,
                         transport=transport)
        self.add_hook(self.HOOK_MESSAGE_IN)
        self.add_hook(self.HOOK_MESSAGE_CALL)

        self._mailbox_control = f"{self.topic_path}/mb_control"
        self._mailbox_in = f"{self.topic_path}/mb_in"
        engine = self.runtime.engine
        engine.add_mailbox_handler(self._mailbox_handler,
                                   self._mailbox_control)
        engine.add_mailbox_handler(self._mailbox_handler, self._mailbox_in)

        self.runtime.add_message_handler(self._topic_control_handler,
                                         self.topic_control)
        self.runtime.add_message_handler(self._topic_in_handler,
                                         self.topic_in)

        self.share: dict = {
            "lifecycle": "ready",
            "log_level": "INFO",
            "name": self.name,
            "protocol": self.protocol,
            "tags": " ".join(self.tags),
        }
        self.ec_producer = ECProducer(self, self.share)
        self.ec_producer.add_handler(self._ec_share_handler)

    # -- inbound message path ---------------------------------------------

    def _topic_control_handler(self, topic: str, payload):
        self._queue_payload(payload, control=True)

    def _topic_in_handler(self, topic: str, payload):
        self._queue_payload(payload, control=False)

    def _queue_payload(self, payload, control: bool):
        try:
            command, parameters = parse(payload)
        except (SExprError, TypeError):
            self.logger.warning("bad payload: %r", payload)
            return
        if control:
            producer = getattr(self, "ec_producer", None)
            if producer is not None and producer.handle_command(command,
                                                                parameters):
                return
        self.run_hook(self.HOOK_MESSAGE_IN,
                      lambda: {"command": command, "parameters": parameters})
        self._post_message(command, parameters, control=control)

    def _post_message(self, command: str, arguments: list,
                      control: bool = False, delay: float | None = None):
        message = ActorMessage(self, command, list(arguments))
        mailbox = self._mailbox_control if control else self._mailbox_in
        if delay:
            self.runtime.engine.add_oneshot_timer(
                lambda: self.runtime.engine.mailbox_put(mailbox, message),
                delay)
        else:
            self.runtime.engine.mailbox_put(mailbox, message)

    def _mailbox_handler(self, message: ActorMessage):
        self.run_hook(self.HOOK_MESSAGE_CALL,
                      lambda: {"command": message.command,
                               "arguments": message.arguments})
        message.invoke()

    # -- local API ---------------------------------------------------------

    def post_self(self, command: str, arguments: list | None = None,
                  delay: float | None = None, control: bool = False):
        """Queue a (possibly delayed) message to this actor -- the safe way
        to call actor methods from foreign threads or timers (reference
        actor.py:256-284)."""
        self._post_message(command, arguments or [], control=control,
                           delay=delay)

    def in_mailbox_size(self) -> int:
        return self.runtime.engine.mailbox_size(self._mailbox_in)

    # -- share plumbing ----------------------------------------------------

    def _ec_share_handler(self, action: str, item_name: str, item_value):
        if action == "update" and item_name == "log_level":
            self.set_log_level(str(item_value))
            self.share["log_level"] = str(item_value)

    def stop(self):
        engine = self.runtime.engine
        engine.remove_mailbox_handler(self._mailbox_control)
        engine.remove_mailbox_handler(self._mailbox_in)
        self.runtime.remove_message_handler(self._topic_control_handler,
                                            self.topic_control)
        self.runtime.remove_message_handler(self._topic_in_handler,
                                            self.topic_in)
        self.ec_producer.terminate()
        super().stop()
