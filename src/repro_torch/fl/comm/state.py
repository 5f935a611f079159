"""Per-run communication state: error feedback + bytes-on-wire accounting,
ported from ``repro/fl/comm/state.py``.

``CommState`` sits between a client's local update and the server's
aggregation.  Error feedback (EF / EF21 family), for client i with residual
e_i:

    c   = (w_i − w̄) + e_i          # compress the residual-corrected delta
    p   = encode(c);  d = decode(p)
    e_i ← c − d                     # what the wire dropped, retried next time
    ŵ_i = w̄ + d                    # what the server reconstructs

For lossless codecs e_i stays exactly zero and ŵ_i ≡ w_i.

Downlink: with ``downlink_codec`` the server's broadcast travels through
that codec with a *server-side* error-feedback residual: the server tracks
``_dl_ref``, the decoded global replica every client holds, encodes the
delta (new global − replica) + residual each round, and clients apply the
decoded delta to their replica, which ``broadcast`` returns: clients train
from what they could have received.  The first broadcast (enrollment)
ships the full model at ``ref_bytes``.  ``downlink_codec=None`` keeps the
exact fp32 broadcast.

Every codec's payload size is value-independent, so ``upload_bytes`` is
known before local training; ``model_bytes_override`` scales wire bytes by
each codec's exact compression ratio on the real template.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.fl.comm.codecs import Codec, Payload, make_codec
from repro_torch.obs.sync import block_until_ready
from repro_torch.obs.telemetry import NULL_TELEMETRY
from repro_torch.tree import tree_flatten, tree_leaves, tree_map, tree_unflatten


def fp32_nbytes(template) -> int:
    """Bytes of the baseline uncompressed fp32 upload of ``template``."""
    return sum(4 * l.numel() for l in tree_leaves(template))


class _ResidualStore:
    """Error-feedback residuals for all clients, leaf-major.

    Dense mode (``n`` known): one ``(N, *leaf.shape)`` float32 tensor per
    template leaf on the template's device, allocated lazily on the first
    lossy store, plus an ``(N,)`` presence mask.  Sparse mode (``n`` is
    None): a plain per-client dict.  ``get`` always returns a fresh tree
    (copies of the rows), so a caller-held residual is never aliased by a
    later store.
    """

    def __init__(self, template, n: Optional[int]):
        self.n = n
        leaves, self._treedef = tree_flatten(template)
        self._shapes = [tuple(l.shape) for l in leaves]
        self._device = leaves[0].device if leaves else torch.device("cpu")
        self._dict: Optional[Dict[int, Any]] = {} if n is None else None
        self._stacks: Optional[list] = None
        self._present = None if n is None else np.zeros(n, dtype=bool)

    def clear(self) -> None:
        if self._dict is not None:
            self._dict.clear()
        else:
            self._stacks = None
            self._present[:] = False

    def get(self, client: int):
        if self._dict is not None:
            return self._dict.get(client)
        if self._stacks is None or not self._present[client]:
            return None
        return tree_unflatten(self._treedef,
                              [s[client].clone() for s in self._stacks])

    def set(self, client: int, tree) -> None:
        if self._dict is not None:
            self._dict[client] = tree
            return
        if self._stacks is None:
            self._stacks = [torch.zeros((self.n,) + shp, dtype=torch.float32,
                                        device=self._device)
                            for shp in self._shapes]
        for s, leaf in zip(self._stacks, tree_leaves(tree)):
            s[client].copy_(leaf)
        self._present[client] = True

    def pop(self, client: int) -> None:
        if self._dict is not None:
            self._dict.pop(client, None)
        elif self._present is not None:
            self._present[client] = False


class _DenseFloatMap:
    """Dict-shaped view over a dense ``(N,)`` float array + presence mask.

    Drop-in for the per-client ``last_distortions`` dict when the
    population size is known: ``m[i]`` / ``m[i] = x`` / ``m.get(i)`` /
    ``i in m`` / ``len(m)`` all work, backed by two fixed arrays instead
    of a hash map that churns at population scale."""

    def __init__(self, n: int):
        self._vals = np.zeros(n, dtype=np.float64)
        self._present = np.zeros(n, dtype=bool)

    def __getitem__(self, client: int) -> float:
        if not self._present[client]:
            raise KeyError(client)
        return float(self._vals[client])

    def __setitem__(self, client: int, value: float) -> None:
        self._vals[client] = value
        self._present[client] = True

    def __contains__(self, client) -> bool:
        c = int(client)
        return 0 <= c < len(self._vals) and bool(self._present[c])

    def __len__(self) -> int:
        return int(self._present.sum())

    def get(self, client: int, default: float = None):
        c = int(client)
        if 0 <= c < len(self._vals) and self._present[c]:
            return float(self._vals[c])
        return default

    def clear(self) -> None:
        self._present[:] = False
        self._vals[:] = 0.0

    def keys(self):
        return (int(i) for i in np.nonzero(self._present)[0])

    def items(self):
        return ((int(i), float(self._vals[i]))
                for i in np.nonzero(self._present)[0])


def _l2(tree) -> float:
    """Global L2 norm across all leaves of a tree (fp32 accumulate)."""
    total = sum(torch.sum(torch.square(l.to(torch.float32)))
                for l in tree_leaves(tree))
    return float(torch.sqrt(total))


class CommState:
    """Codec + per-client error-feedback residuals for one runner."""

    def __init__(self, codec: Codec, template, *,
                 model_bytes_override: Optional[float] = None,
                 lora_cfg=None, downlink_codec: Optional[Codec] = None,
                 n_clients: Optional[int] = None):
        codec.validate_template(template, lora_cfg=lora_cfg)
        if downlink_codec is not None:
            downlink_codec.validate_template(template, lora_cfg=lora_cfg)
        self.codec = codec
        self.downlink_codec = downlink_codec
        self._template = template
        self._lora_cfg = lora_cfg
        self._model_bytes_override = model_bytes_override
        self.fp32_nbytes = fp32_nbytes(template)
        self._codec_cache: Dict[str, Codec] = {codec.name: codec}
        self._nbytes_cache: Dict[str, float] = {}
        # ``ref_bytes`` is the uncompressed fp32 reference everything scales
        # against (the historical ``model_bytes``)
        self.ref_bytes = (float(model_bytes_override)
                          if model_bytes_override is not None
                          else float(self.fp32_nbytes))
        self.upload_bytes = self.nbytes_for(codec)
        self.download_bytes = (self.ref_bytes if downlink_codec is None
                               else self.nbytes_for(downlink_codec))
        self.n_clients = n_clients
        self._residuals = _ResidualStore(template, n_clients)
        self._dl_ref = None                    # clients' decoded global replica
        self._dl_residual = None               # server-side EF residual
        self.total_uplink_bytes = 0.0          # cumulative, all clients
        self.total_downlink_bytes = 0.0        # cumulative broadcast bytes
        self.n_encoded = 0
        # last measured normalized compression distortion per client
        # (‖carry − decoded‖/‖carry‖; exactly 0.0 for lossless uploads):
        # a dense array when the population size is declared
        self.last_distortions = (_DenseFloatMap(n_clients)
                                 if n_clients is not None else {})
        # telemetry hub (repro_torch.obs); the runner swaps in a live one per
        # instrumented run: the comm counters are a third, independent
        # accounting the reconcile cross-check compares against
        self.telemetry = NULL_TELEMETRY

    # -------------------------------------------------------------- sizing
    def codec_named(self, name: str) -> Codec:
        """Resolve (and cache) a codec by spec, validated on the template."""
        if name not in self._codec_cache:
            c = make_codec(name)
            c.validate_template(self._template, lora_cfg=self._lora_cfg)
            self._codec_cache[name] = c
        return self._codec_cache[name]

    def nbytes_for(self, codec) -> float:
        """Simulated wire bytes of one upload under ``codec`` (a ``Codec``
        or a spec string): exact template bytes, scaled by the codec's
        compression ratio when ``model_bytes`` is overridden."""
        if isinstance(codec, str):
            codec = self.codec_named(codec)
        if codec.name not in self._nbytes_cache:
            exact = codec.nbytes(self._template)
            self._nbytes_cache[codec.name] = (
                float(exact) if self._model_bytes_override is None
                else float(self._model_bytes_override * exact /
                           max(self.fp32_nbytes, 1)))
        return self._nbytes_cache[codec.name]

    # ---------------------------------------------------------------- wire
    def reset(self) -> None:
        self._residuals.clear()
        self._dl_ref = None
        self._dl_residual = None
        self.total_uplink_bytes = 0.0
        self.total_downlink_bytes = 0.0
        self.n_encoded = 0
        self.last_distortions.clear()

    def residual(self, client: int):
        return self._residuals.get(client)

    def _encode(self, client: int, model, global_params,
                codec: Optional[Codec]):
        """Client-side half of one upload: delta, EF carry, encode, residual
        update, byte charging.  Returns ``(payload, decoded, distortion)``;
        ``decoded`` is what the server will reconstruct, which error
        feedback needs client-side."""
        codec = self.codec if codec is None else codec
        delta = tree_map(lambda w, g: w.to(torch.float32) - g.to(torch.float32),
                         model, global_params)
        resid = self._residuals.get(client)
        distortion = 0.0
        if codec.lossless and resid is None:
            payload = codec.encode(delta)
            decoded = codec.decode(payload)
        else:
            carry = delta if resid is None else tree_map(torch.add, delta, resid)
            payload = codec.encode(carry)
            decoded = codec.decode(payload)
            if codec.lossless:
                # wire carried the full corrected delta: residual flushed
                self._residuals.pop(client)
            else:
                new_resid = tree_map(torch.sub, carry, decoded)
                self._residuals.set(client, new_resid)
                carry_norm = _l2(carry)
                if carry_norm > 0.0:
                    distortion = _l2(new_resid) / carry_norm
        nbytes = self.nbytes_for(codec)
        self.total_uplink_bytes += nbytes
        self.n_encoded += 1
        self.last_distortions[client] = distortion
        tel = self.telemetry
        if tel:
            tel.counter("comm.uploads")
            tel.counter("comm.upload_bytes", nbytes)
        return payload, decoded, distortion

    def encode_upload(self, client: int, model, global_params, *,
                      codec: Optional[Codec] = None) -> Tuple[Payload, float]:
        """Client-side encode of one upload, for the streaming server path:
        returns ``(payload, distortion)``; the server feeds the packed
        payload to a ``StreamAccumulator`` and never builds the fp32 delta.
        Under a live hub the encode is timed as ``phase.uplink`` and the
        device synchronized before the timer closes
        (``repro/fl/comm/state.py:316-321``)."""
        tel = self.telemetry
        with tel.timer("phase.uplink"):
            payload, _decoded, distortion = self._encode(
                client, model, global_params, codec)
            block_until_ready(tel, [el.data for el in payload.leaves])
        return payload, distortion

    def decode_upload(self, payload: Payload, global_params,
                      codec: Optional[Codec] = None):
        """Server-side decode of one packed upload back to a full model
        tree — the materializing path.  Counts itself as a fallback in the
        ``uplink_decode`` attribution (``repro/fl/comm/state.py:333-345``)."""
        tel = self.telemetry
        with tel.timer("phase.uplink_decode"):
            codec = (self.codec if codec is None else
                     self.codec_named(codec) if isinstance(codec, str)
                     else codec)
            decoded = codec.decode(payload)
            recon = tree_map(
                lambda g, d: (g.to(torch.float32) + d).to(g.dtype),
                global_params, decoded)
            if tel:
                block_until_ready(tel, recon)
                tel.counter("uplink.fallback_payloads")
                tel.counter("uplink.decoded_bytes", self.fp32_nbytes)
        return recon

    def roundtrip(self, client: int, model, global_params, *,
                  codec: Optional[Codec] = None) -> Tuple[Any, Payload, float]:
        """Client-encode then server-decode one upload.  Returns
        ``(reconstructed_model, payload, distortion)``; the encode-side
        decode is reused, so the materializing path decodes once.  Timed as
        ``phase.uplink`` (``repro/fl/comm/state.py:367-376``)."""
        tel = self.telemetry
        with tel.timer("phase.uplink"):
            payload, decoded, distortion = self._encode(
                client, model, global_params, codec)
            recon = tree_map(
                lambda g, d: (g.to(torch.float32) + d).to(g.dtype),
                global_params, decoded)
            block_until_ready(tel, recon)
        return recon, payload, distortion

    # ----------------------------------------------------------- downlink
    def next_broadcast_nbytes(self) -> float:
        """Wire bytes the next ``broadcast`` will charge: ``ref_bytes`` for
        a downlink codec's first (enrollment) broadcast, ``download_bytes``
        otherwise."""
        if self.downlink_codec is not None and self._dl_ref is None:
            return float(self.ref_bytes)
        return float(self.download_bytes)

    def broadcast(self, global_params) -> Tuple[Any, float]:
        """Server-encode the round's broadcast; returns ``(params clients
        start from, simulated broadcast bytes)``.  Without a downlink codec
        that is the exact global model at fp32 size.  With one, the first
        broadcast sets the replica to the global (charged ``ref_bytes``);
        later ones encode (global − replica) + residual, keep the new
        residual, and advance the replica by the decoded delta.  Timed as
        ``phase.downlink`` (``repro/fl/comm/state.py:405-437``)."""
        tel = self.telemetry
        with tel.timer("phase.downlink"):
            if self.downlink_codec is None:
                self.total_downlink_bytes += self.download_bytes
                if tel:
                    tel.counter("comm.broadcasts")
                    tel.counter("comm.download_bytes", self.download_bytes)
                return global_params, self.download_bytes
            nbytes = self.download_bytes
            if self._dl_ref is None:
                self._dl_ref = tree_map(
                    lambda g: g.to(torch.float32).clone(), global_params)
                nbytes = self.ref_bytes      # enrollment: full-model transfer
            else:
                delta = tree_map(lambda g, ref: g.to(torch.float32) - ref,
                                 global_params, self._dl_ref)
                if self._dl_residual is not None:
                    delta = tree_map(torch.add, delta, self._dl_residual)
                decoded = self.downlink_codec.decode(
                    self.downlink_codec.encode(delta))
                if not self.downlink_codec.lossless:
                    self._dl_residual = tree_map(torch.sub, delta, decoded)
                self._dl_ref = tree_map(torch.add, self._dl_ref, decoded)
            self.total_downlink_bytes += nbytes
            out = tree_map(lambda ref, g: ref.to(g.dtype), self._dl_ref,
                           global_params)
            if tel:
                block_until_ready(tel, out)
                tel.counter("comm.broadcasts")
                tel.counter("comm.download_bytes", nbytes)
        return out, nbytes
