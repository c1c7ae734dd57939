"""Minimal pure-Python PostgreSQL wire-protocol (v3) client, DB-API shaped.

This image ships no Postgres driver (psycopg2/pg8000 absent), so the Aigle
DB surface (aigle/db.py — live export transaction, model-registry lookup,
geozone view; reference utils/export.py:48-115, utils/s3.py:26-98) would
be dead code in production images without one. This client implements the
slice the framework needs and nothing more:

* startup + authentication: trust, cleartext, MD5, SCRAM-SHA-256
  (RFC 5802/7677, channel binding not advertised),
* the simple-query protocol ('Q'): text-format results with basic type
  decoding (bool/int/float/numeric; everything else stays str),
* DB-API-ish Connection/Cursor with implicit BEGIN and commit()/rollback()
  — what aigle/db.py's Database wrapper drives.

Extended query protocol, COPY, binary formats and notifications are out of
scope. Server ErrorResponses raise DatabaseError with the server message.
"""

from __future__ import annotations

import base64
import hashlib
import hmac
import os
import socket
import struct


class DatabaseError(Exception):
    pass


_TYPE_DECODERS = {
    16: lambda s: s == "t",                       # bool
    20: int, 21: int, 23: int, 26: int,           # int8/int2/int4/oid
    700: float, 701: float, 1700: float,          # float4/float8/numeric
}


def _pack_msg(tag: bytes, payload: bytes) -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


class _Stream:
    def __init__(self, sock: socket.socket):
        self.sock = sock
        self._buf = b""

    def _recv_exact(self, n: int) -> bytes:
        while len(self._buf) < n:
            chunk = self.sock.recv(65536)
            if not chunk:
                raise DatabaseError("server closed the connection")
            self._buf += chunk
        out, self._buf = self._buf[:n], self._buf[n:]
        return out

    def read_message(self) -> tuple[bytes, bytes]:
        head = self._recv_exact(5)
        tag = head[:1]
        (length,) = struct.unpack("!I", head[1:5])
        return tag, self._recv_exact(length - 4)

    def send(self, data: bytes) -> None:
        self.sock.sendall(data)


def _error_message(payload: bytes) -> str:
    parts = {}
    for field in payload.split(b"\x00"):
        if field:
            parts[chr(field[0])] = field[1:].decode("utf-8", "replace")
    sev = parts.get("S", "ERROR")
    return f"{sev}: {parts.get('M', '(no message)')}" + (
        f" [{parts['C']}]" if "C" in parts else ""
    )


class Connection:
    def __init__(self, user: str, host: str = "127.0.0.1", port: int = 5432,
                 database: str | None = None, password: str | None = None,
                 timeout: float = 30.0):
        self.user = user
        self._in_tx = False
        self._closed = False
        sock = socket.create_connection((host, port), timeout=timeout)
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._s = _Stream(sock)
        params = {"user": user, "client_encoding": "UTF8"}
        if database:
            params["database"] = database
        payload = struct.pack("!I", 196608)  # protocol 3.0
        for k, v in params.items():
            payload += k.encode() + b"\x00" + v.encode() + b"\x00"
        payload += b"\x00"
        self._s.send(struct.pack("!I", len(payload) + 4) + payload)
        self._authenticate(password or "")
        # drain until ReadyForQuery
        while True:
            tag, body = self._s.read_message()
            if tag == b"Z":
                break
            if tag == b"E":
                raise DatabaseError(_error_message(body))

    # -- auth -------------------------------------------------------------
    def _authenticate(self, password: str) -> None:
        while True:
            tag, body = self._s.read_message()
            if tag == b"E":
                raise DatabaseError(_error_message(body))
            if tag != b"R":
                # ParameterStatus/BackendKeyData may arrive post-auth, and
                # the server may send NoticeResponse at any time (e.g. a
                # deprecation warning during startup); none of these end auth
                if tag in (b"S", b"K", b"N"):
                    continue
                raise DatabaseError(f"unexpected message {tag!r} during auth")
            (code,) = struct.unpack("!I", body[:4])
            if code == 0:
                return
            if code == 3:  # cleartext
                self._s.send(_pack_msg(b"p", password.encode() + b"\x00"))
            elif code == 5:  # md5
                salt = body[4:8]
                inner = hashlib.md5(
                    password.encode() + self.user.encode()).hexdigest()
                digest = hashlib.md5(inner.encode() + salt).hexdigest()
                self._s.send(_pack_msg(b"p", b"md5" + digest.encode() + b"\x00"))
            elif code == 10:  # SASL: pick SCRAM-SHA-256
                mechs = [m for m in body[4:].split(b"\x00") if m]
                if b"SCRAM-SHA-256" not in mechs:
                    raise DatabaseError(
                        f"no supported SASL mechanism in {mechs}"
                    )
                self._scram(password)
            elif code in (11, 12):
                raise DatabaseError("unexpected SASL continuation")
            else:
                raise DatabaseError(f"unsupported auth method {code}")

    def _scram(self, password: str) -> None:
        nonce = base64.b64encode(os.urandom(18)).decode()
        first_bare = f"n=,r={nonce}"
        init = b"SCRAM-SHA-256\x00" + struct.pack("!I", len(first_bare) + 3) \
            + b"n,," + first_bare.encode()
        self._s.send(_pack_msg(b"p", init))
        tag, body = self._s.read_message()
        if tag == b"E":
            raise DatabaseError(_error_message(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 11:
            raise DatabaseError(f"expected SASLContinue, got code {code}")
        server_first = body[4:].decode()
        attrs = dict(kv.split("=", 1) for kv in server_first.split(","))
        if not attrs["r"].startswith(nonce):
            raise DatabaseError("server nonce does not extend client nonce")
        salt = base64.b64decode(attrs["s"])
        iters = int(attrs["i"])
        salted = hashlib.pbkdf2_hmac("sha256", password.encode(), salt, iters)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        final_wo_proof = f"c=biws,r={attrs['r']}"
        auth_msg = ",".join([first_bare, server_first, final_wo_proof])
        sig = hmac.digest(stored_key, auth_msg.encode(), "sha256")
        proof = bytes(a ^ b for a, b in zip(client_key, sig))
        final = final_wo_proof + ",p=" + base64.b64encode(proof).decode()
        self._s.send(_pack_msg(b"p", final.encode()))
        tag, body = self._s.read_message()
        if tag == b"E":
            raise DatabaseError(_error_message(body))
        (code,) = struct.unpack("!I", body[:4])
        if code != 12:
            raise DatabaseError(f"expected SASLFinal, got code {code}")
        server_final = body[4:].decode()
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        want_v = base64.b64encode(
            hmac.digest(server_key, auth_msg.encode(), "sha256")).decode()
        got_v = dict(kv.split("=", 1)
                     for kv in server_final.split(",")).get("v")
        if got_v != want_v:
            raise DatabaseError("server signature verification failed")

    # -- queries ----------------------------------------------------------
    def _simple_query(self, sql: str):
        self._s.send(_pack_msg(b"Q", sql.encode() + b"\x00"))
        description = None
        decoders: list = []
        rows: list[tuple] = []
        status = None
        error = None
        while True:
            tag, body = self._s.read_message()
            if tag == b"T":
                (n_fields,) = struct.unpack("!H", body[:2])
                off = 2
                description = []
                decoders = []
                for _ in range(n_fields):
                    end = body.index(b"\x00", off)
                    name = body[off:end].decode()
                    off = end + 1
                    _tbl, _col, typ, _len, _mod, _fmt = struct.unpack(
                        "!IHIhiH", body[off:off + 18]
                    )
                    off += 18
                    description.append((name, typ, None, None, None, None,
                                        None))
                    decoders.append(_TYPE_DECODERS.get(typ))
            elif tag == b"D":
                (n_fields,) = struct.unpack("!H", body[:2])
                off = 2
                row = []
                for i in range(n_fields):
                    (ln,) = struct.unpack("!i", body[off:off + 4])
                    off += 4
                    if ln == -1:
                        row.append(None)
                        continue
                    text = body[off:off + ln].decode()
                    off += ln
                    dec = decoders[i] if i < len(decoders) else None
                    row.append(dec(text) if dec else text)
                rows.append(tuple(row))
            elif tag == b"C":
                status = body.rstrip(b"\x00").decode()
            elif tag == b"E":
                error = _error_message(body)
            elif tag == b"Z":
                self._in_tx = body[:1] in (b"T", b"E")
                break
            # 'N' NoticeResponse, 'S', 'I' EmptyQueryResponse: ignore
        if error:
            raise DatabaseError(error)
        return description, rows, status

    # -- DB-API surface ----------------------------------------------------
    def cursor(self) -> "Cursor":
        return Cursor(self)

    def commit(self) -> None:
        if self._in_tx:
            self._simple_query("COMMIT")

    def rollback(self) -> None:
        if self._in_tx:
            self._simple_query("ROLLBACK")

    def close(self) -> None:
        if not self._closed:
            try:
                self._s.send(_pack_msg(b"X", b""))
            except OSError:
                pass
            self._s.sock.close()
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Cursor:
    def __init__(self, conn: Connection):
        self._conn = conn
        self.description = None
        self._rows: list[tuple] = []
        self._idx = 0
        self.rowcount = -1

    def execute(self, sql: str) -> None:
        conn = self._conn
        if not conn._in_tx and not sql.lstrip().upper().startswith(
                ("BEGIN", "COMMIT", "ROLLBACK", "START")):
            conn._simple_query("BEGIN")
        self.description, self._rows, status = conn._simple_query(sql)
        self._idx = 0
        if status and status.split()[-1].isdigit():
            self.rowcount = int(status.split()[-1])
        else:
            self.rowcount = len(self._rows) if self.description else -1

    def fetchone(self):
        if self._idx >= len(self._rows):
            return None
        row = self._rows[self._idx]
        self._idx += 1
        return row

    def fetchall(self):
        rows = self._rows[self._idx:]
        self._idx = len(self._rows)
        return rows

    def close(self) -> None:
        self._rows = []


def connect(user: str, host: str = "127.0.0.1", port: int = 5432,
            database: str | None = None, password: str | None = None,
            **_ignored) -> Connection:
    return Connection(user=user, host=host, port=port, database=database,
                      password=password)
