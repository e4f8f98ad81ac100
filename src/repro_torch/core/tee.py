"""TEE (Intel SGX) enclave simulation, the port's copy.

The card has no hardware TEE, so what is kept is the *system role* the
enclave plays: an explicit trust boundary object with the paper's
lifecycle.

  * remote attestation  -> ``attest()`` returns a measurement/quote record
    that clients verify before sealing data to the enclave
  * sealed sample store -> client samples are stored encrypted (a keyed
    XOR stands in for AES-GCM: confidentiality is simulated, the data-flow
    discipline is real, since plaintext samples are reachable only
    through Enclave methods)
  * EPC memory budget   -> 128 MB; growth past it counts SGX paging events

The store is numpy and hashlib, byte for byte the reference's format;
``unseal_samples`` hands the samples back as tensors on the enclave's
device.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

EPC_BYTES = 128 * 2 ** 20          # SGX v1 enclave page cache (paper Sec. IV-D)
PAGE_BYTES = 4096                  # SGX EPC page granularity


@dataclasses.dataclass
class AttestationQuote:
    measurement: str           # hash of the enclave code identity
    nonce: int


class Enclave:
    """Software-simulated SGX enclave on the FL server."""

    def __init__(self, code_identity: str = "diversefl-enclave-v1",
                 epc_bytes: int = EPC_BYTES, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self._measurement = hashlib.sha256(code_identity.encode()).hexdigest()
        self._seal_key = np.random.default_rng(seed).integers(
            0, 255, size=32, dtype=np.uint8)
        self._store: Dict[int, bytes] = {}
        self._meta: Dict[int, dict] = {}
        self.epc_bytes = epc_bytes
        self.paging_events = 0
        self.seal_version = 0      # bumped on every store mutation (cache key)

    # --- attestation -------------------------------------------------
    def attest(self, nonce: int) -> AttestationQuote:
        return AttestationQuote(self._measurement, nonce)

    @staticmethod
    def verify_quote(quote: AttestationQuote, expected_identity: str,
                     nonce: int) -> bool:
        exp = hashlib.sha256(expected_identity.encode()).hexdigest()
        return quote.measurement == exp and quote.nonce == nonce

    # --- sealed sample store (Step 1) ---------------------------------
    def _xor(self, raw: bytes) -> bytes:
        key = np.frombuffer(
            (self._seal_key.tobytes() * (len(raw) // 32 + 1))[:len(raw)],
            dtype=np.uint8)
        return (np.frombuffer(raw, np.uint8) ^ key).tobytes()

    def seal_samples(self, client_id: int, x, y) -> None:
        if isinstance(x, torch.Tensor):
            x = x.detach().cpu().numpy()
        if isinstance(y, torch.Tensor):
            y = y.detach().cpu().numpy()
        x = np.asarray(x, np.float32)
        y = np.asarray(y, np.int32)
        prev_over = max(0, self.stored_bytes() - self.epc_bytes)
        self._store[client_id] = self._xor(x.tobytes() + y.tobytes())
        self._meta[client_id] = {"x_shape": x.shape, "y_shape": y.shape}
        self.seal_version += 1
        # EPC spillover is paged at 4 KB granularity: each seal that grows
        # the store past the budget costs one event per spilled page
        new_over = max(0, self.stored_bytes() - self.epc_bytes)
        if new_over > prev_over:
            self.paging_events += -(-(new_over - prev_over) // PAGE_BYTES)

    def unseal_samples(self, client_id: int):
        """(x float32, y int64) tensors on the enclave's device."""
        blob = self._xor(self._store[client_id])
        meta = self._meta[client_id]
        nx = int(np.prod(meta["x_shape"]))
        x = np.frombuffer(blob[: 4 * nx], np.float32).reshape(meta["x_shape"])
        y = np.frombuffer(blob[4 * nx:], np.int32).reshape(meta["y_shape"])
        return (torch.from_numpy(x.copy()).to(self.device),
                torch.from_numpy(y.astype(np.int64)).to(self.device))

    def stored_bytes(self) -> int:
        return sum(len(b) for b in self._store.values())

    def client_ids(self):
        return sorted(self._store.keys())

    def drop_client(self, client_id: int) -> None:
        self._store.pop(client_id, None)
        self._meta.pop(client_id, None)
        self.seal_version += 1

    # --- throughput model (Fig. 9 / Sec. IV-D) -------------------------
    @staticmethod
    def max_clients(guide_flops: float, client_step_seconds: float,
                    tee_flops_per_s: float = 50e9,
                    model_bytes: int = 0) -> int:
        """How many clients one enclave supports without stalling training:
        the TEE processes clients sequentially (SGX memory limits), so it
        needs N * t_guide <= t_client.  Models fall off a cliff when the
        model doesn't fit EPC (paper: VGG-11 ~3x slowdown)."""
        t_guide = guide_flops / tee_flops_per_s
        if model_bytes > EPC_BYTES:
            t_guide *= 3.0          # paging overhead regime
        if t_guide <= 0:
            return 10 ** 9
        return max(1, int(client_step_seconds / t_guide))
