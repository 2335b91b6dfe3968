"""Minimal RFC 6455 WebSocket server support on the stdlib http.server.

The real-time voice demo streams mic PCM from the browser and token text
back (reference surface: tools/gradio_voice.py's WebRTC transport). No
websocket dependency is bundled, so the handshake + frame codec live here —
~120 lines covers what the demo needs (binary/text frames, ping/pong,
close, server→client unmasked sends).
"""

from __future__ import annotations

import base64
import hashlib
import struct
from typing import Optional, Tuple

GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# frames larger than this close the connection (a hostile 2^63-byte length
# header would otherwise OOM the server buffering it)
MAX_FRAME_BYTES = 16 * 1024 * 1024

OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = 0, 1, 2, 8, 9, 10


def accept_key(client_key: str) -> str:
    digest = hashlib.sha1((client_key + GUID).encode()).digest()
    return base64.b64encode(digest).decode()


def perform_handshake(handler) -> bool:
    """Upgrade an http.server request to a WebSocket. Returns success."""
    key = handler.headers.get("Sec-WebSocket-Key")
    upgrade = (handler.headers.get("Upgrade") or "").lower()
    if not key or upgrade != "websocket":
        handler.send_response(400)
        handler.end_headers()
        return False
    handler.send_response_only(101, "Switching Protocols")
    handler.send_header("Upgrade", "websocket")
    handler.send_header("Connection", "Upgrade")
    handler.send_header("Sec-WebSocket-Accept", accept_key(key))
    handler.end_headers()
    handler.wfile.flush()
    return True


class WebSocketConnection:
    """Frame-level reader/writer over the handler's rfile/wfile."""

    def __init__(self, handler):
        self.rfile = handler.rfile
        self.wfile = handler.wfile
        self.open = True

    # -- receive -----------------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        parts = []
        got = 0
        while got < n:
            chunk = self.rfile.read(n - got)
            if not chunk:
                raise ConnectionError("websocket peer closed")
            parts.append(chunk)
            got += len(chunk)
        return b"".join(parts)

    def recv(self) -> Optional[Tuple[int, bytes]]:
        """Next complete message as (opcode, payload); None once closed.
        Handles continuation frames and answers pings."""
        message = b""
        message_op = None
        while True:
            if not self.open:
                return None
            head = self._read_exact(2)
            fin = head[0] & 0x80
            opcode = head[0] & 0x0F
            masked = head[1] & 0x80
            length = head[1] & 0x7F
            if length == 126:
                (length,) = struct.unpack("!H", self._read_exact(2))
            elif length == 127:
                (length,) = struct.unpack("!Q", self._read_exact(8))
            if length > MAX_FRAME_BYTES:
                self.close()
                raise ConnectionError(
                    f"websocket frame of {length} bytes exceeds the "
                    f"{MAX_FRAME_BYTES}-byte limit"
                )
            mask = self._read_exact(4) if masked else None
            payload = self._read_exact(length)
            if mask:
                payload = bytes(
                    b ^ mask[i % 4] for i, b in enumerate(payload)
                )
            if opcode == OP_CLOSE:
                self.close()
                return None
            if opcode == OP_PING:
                self._send_frame(OP_PONG, payload)
                continue
            if opcode == OP_PONG:
                continue
            if opcode in (OP_TEXT, OP_BIN):
                message_op = opcode
                message = payload
            elif opcode == OP_CONT:
                message += payload
            if fin:
                return message_op, message

    # -- send --------------------------------------------------------------

    def _send_frame(self, opcode: int, payload: bytes) -> None:
        if not self.open:
            return
        header = bytes([0x80 | opcode])
        n = len(payload)
        if n < 126:
            header += bytes([n])
        elif n < (1 << 16):
            header += bytes([126]) + struct.pack("!H", n)
        else:
            header += bytes([127]) + struct.pack("!Q", n)
        try:
            self.wfile.write(header + payload)
            self.wfile.flush()
        except (BrokenPipeError, ConnectionError):
            self.open = False

    def send_text(self, text: str) -> None:
        self._send_frame(OP_TEXT, text.encode("utf-8"))

    def send_bytes(self, data: bytes) -> None:
        self._send_frame(OP_BIN, data)

    def close(self) -> None:
        if self.open:
            self._send_frame(OP_CLOSE, b"")
            self.open = False
