"""File-backed storage: three JSON files + optional AES-256-CBC encryption.

Behavioral twin of bullet-js src/bullet-file-storage.js:
``store.json``/``meta.json``/``log.json`` under the storage path (:105-141,
:177-187), synchronous load-and-deep-merge on construction (:96-163),
periodic autosave (:44-48), save-on-exit (:51-83, via atexit here), and the
same encrypted file format — ``hex(iv) + hex(ciphertext)`` with the key being
SHA-256 of the passphrase (:218-289) — so files written by the Node reference
with the same passphrase decrypt here and vice versa.

The port's own copy of ``bullet_tpu/db/file_storage.py`` (no JAX, no torch), so that the port
imports nothing of the JAX package.
"""

from __future__ import annotations

import atexit
import hashlib
import json
import os
import threading
from typing import Optional

from ..utils.jsvalues import deep_copy
from .storage import BulletStorage


def _get_cipher_backend():
    try:
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        return Cipher, algorithms, modes
    except ImportError as err:  # pragma: no cover - environment-dependent
        raise RuntimeError(
            "encrypted storage requires the 'cryptography' package"
        ) from err


class BulletFileStorage(BulletStorage):
    def __init__(self, bullet, options: Optional[dict] = None) -> None:
        super().__init__(
            bullet,
            {
                "path": "./.bullet",
                "save_interval": 5.0,
                "encrypt": False,
                "encryption_key": None,
                "enable_storage_log": False,
                **(options or {}),
            },
        )
        os.makedirs(self.options["path"], exist_ok=True)
        self._save_timer: Optional[threading.Timer] = None
        self._closed = False
        self._init_storage()

    def _init_storage(self) -> None:
        self._load_data()
        interval = self.options.get("save_interval") or 0
        if interval > 0:
            self._arm_timer(interval)
        atexit.register(self._exit_save)

    def _arm_timer(self, interval: float) -> None:
        def tick():
            if self._closed:
                return
            try:
                self._save_data()
            finally:
                if not self._closed:
                    self._arm_timer(interval)

        self._save_timer = threading.Timer(interval, tick)
        self._save_timer.daemon = True
        self._save_timer.start()

    def _exit_save(self) -> None:
        if not self._closed:
            try:
                self._save_data()
            except Exception:  # noqa: BLE001 - exit-path save is best-effort
                pass

    # ------------------------------------------------------------------ load

    def _file(self, name: str) -> str:
        return os.path.join(self.options["path"], name)

    def _load_data(self) -> None:
        """Load and deep-merge store/meta/log (bullet-file-storage.js:96-163)."""
        mw = self.bullet.middleware
        try:
            if os.path.exists(self._file("store.json")):
                with open(self._file("store.json"), "rb") as f:
                    parsed = json.loads(self._decrypt(f.read()))
                self._deep_merge(self.bullet.store, parsed)
                self.persisted["store"] = deep_copy(self.bullet.store)

            if os.path.exists(self._file("meta.json")):
                with open(self._file("meta.json"), "rb") as f:
                    parsed = json.loads(self._decrypt(f.read()))
                self.bullet.meta.update(parsed)
                self.persisted["meta"] = deep_copy(self.bullet.meta)

            if os.path.exists(self._file("log.json")):
                with open(self._file("log.json"), "rb") as f:
                    parsed = json.loads(self._decrypt(f.read()))
                self.bullet.log = [*self.bullet.log, *parsed]
                if len(self.bullet.log) > 1000:
                    self.bullet.log = self.bullet.log[-1000:]
                self.persisted["log"] = list(self.bullet.log)

            if mw is not None:
                mw.emit_event(
                    "storage:load:complete", {"store": self.bullet.store}
                )
        except Exception as err:  # noqa: BLE001
            if mw is not None:
                mw.emit_event("storage:error", err)

    # ------------------------------------------------------------------ save

    def _save_data(self) -> None:
        """Write the three files when changed (bullet-file-storage.js:170-210).
        Holds the bullet lock: the autosave timer races concurrent writers
        otherwise (dict-changed-during-iteration in json.dumps)."""
        lock = getattr(self.bullet, "_lock", None)
        if lock is not None:
            with lock:
                self._save_data_locked()
        else:
            self._save_data_locked()

    def _save_data_locked(self) -> None:
        if not self._has_changes():
            return
        mw = self.bullet.middleware
        try:
            if mw is not None:
                mw.emit_event("storage:save:start")
            for name, payload in (
                ("store.json", self.bullet.store),
                ("meta.json", self.bullet.meta),
                ("log.json", self.bullet.log),
            ):
                data = self._encrypt(json.dumps(payload, default=str))
                with open(self._file(name), "wb") as f:
                    f.write(data)
            self.persisted = {
                "store": deep_copy(self.bullet.store),
                "meta": deep_copy(self.bullet.meta),
                "log": list(self.bullet.log),
            }
            if mw is not None:
                mw.emit_event("storage:save:complete")
        except Exception as err:  # noqa: BLE001
            if mw is not None:
                mw.emit_event("storage:error", err)

    # ------------------------------------------------------------ encryption

    def _encryption_key(self) -> bytes:
        """32-byte key, or SHA-256 of the passphrase
        (bullet-file-storage.js:273-289)."""
        key = self.options.get("encryption_key")
        if not key:
            raise ValueError("Encryption key is required when encryption is enabled")
        if isinstance(key, bytes) and len(key) == 32:
            return key
        return hashlib.sha256(str(key).encode("utf-8")).digest()

    def _encrypt(self, data: str) -> bytes:
        if not self.options.get("encrypt"):
            return data.encode("utf-8")
        Cipher, algorithms, modes = _get_cipher_backend()
        key = self._encryption_key()
        iv = os.urandom(16)
        raw = data.encode("utf-8")
        pad = 16 - len(raw) % 16  # PKCS7, matching Node's default padding
        raw += bytes([pad]) * pad
        enc = Cipher(algorithms.AES(key), modes.CBC(iv)).encryptor()
        ciphertext = enc.update(raw) + enc.finalize()
        return (iv.hex() + ciphertext.hex()).encode("utf-8")

    def _decrypt(self, data: bytes) -> str:
        if not self.options.get("encrypt"):
            return data.decode("utf-8")
        try:
            Cipher, algorithms, modes = _get_cipher_backend()
            key = self._encryption_key()
            text = data.decode("utf-8")
            iv = bytes.fromhex(text[:32])
            ciphertext = bytes.fromhex(text[32:])
            dec = Cipher(algorithms.AES(key), modes.CBC(iv)).decryptor()
            raw = dec.update(ciphertext) + dec.finalize()
            return raw[: -raw[-1]].decode("utf-8")  # strip PKCS7
        except Exception:  # noqa: BLE001 - reference falls back to raw content
            return data.decode("utf-8", errors="replace")

    def close(self) -> None:
        self._closed = True
        atexit.unregister(self._exit_save)  # don't pin closed instances
        if self._save_timer is not None:
            self._save_timer.cancel()
            self._save_timer = None
        self._save_data()
