"""Serving runtime: wire protocol, command DSL, session registry, streaming
wake->window->decode pipeline, cross-session batch scheduler, websocket
service and the recycling decode worker.

Reference: the Node/Dart serving stack (``wss/wss.js``,
``dart_wss/lib/dart_wss.dart``, ``dart_wss/lib/parser.dart``) -- re-designed
around one Python asyncio service whose decode path is
``cli.serve.build_decode_fn`` on the card.  Every module here is a copy of
the JAX package's jax-free module of the same name (the port imports
nothing of that package), held to it by ``tests/test_torch_runtime.py`` and
``tests/test_torch_worker.py``; the exports are the JAX package's.
"""

from .protocol import (  # noqa: F401
    BinaryFrame,
    TextFrame,
    decode_binary_frame,
    decode_text_frame,
    encode_binary_frame,
    encode_text_frame,
)
from .auth import (  # noqa: F401
    JwksVerifier,
    make_google_verifier,
    make_token_authenticator,
    sign_token,
    verify_token,
)
from .personalization import (  # noqa: F401
    PersonalizationCrawler,
    parse_wifi_qr,
    wifi_qr_payload,
)
from .dsl import DslError, FunctionCall, Parser  # noqa: F401
from .session import Session, SessionRegistry  # noqa: F401
from .streaming import (  # noqa: F401
    DecodePipeline,
    LatencyStats,
    RingBuffer,
    ThresholdWakeGate,
    Windower,
)
from .batcher import BatchScheduler, BatchingDecodePipeline  # noqa: F401
from .services import ServiceBundle  # noqa: F401
from .actions import DeviceChannel, UserActions, build_action_registry  # noqa: F401
from .commands import build_command_registry, COMMAND_NAMES  # noqa: F401
