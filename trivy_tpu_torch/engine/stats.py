"""`SieveStats`: every engine layer's counters, summed over the calls.

One object a scan engine, shared with its device verifier
(`engine/nfa_device.py`): the all-device engine's sieve, link and
residency counters (`engine/device.py`), the hybrid's pre-sieve and device
verify (`engine/hybrid.py`), the multi-program pass and the license
classifier inside it (`scan_programs`).  `phases()` rounds the phase
seconds and link bytes a run set, for reports.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class SieveStats:
    files: int = 0
    bytes: int = 0
    tiles: int = 0
    candidate_pairs: int = 0
    device_pairs: int = 0  # candidate lanes verified on the device NFA (hybrid)
    confirmed_findings: int = 0
    # Wall-clock per phase (seconds), accumulated across scan_batch calls:
    # host pack, sieve (encode, H2D and kernel launches), candidate derive
    # and fetch, the claim-killer's C walk, exact confirm.
    pack_s: float = 0.0
    sieve_s: float = 0.0
    candidate_s: float = 0.0
    verify_s: float = 0.0
    confirm_s: float = 0.0
    device_dispatches: int = 0
    # Filled only under TRIVY_TPU_SYNC_TIMING=1: the H2D copy (ended by a
    # synchronize) apart from the sieve and its fetch.
    h2d_s: float = 0.0
    exec_s: float = 0.0
    # Chunk-pipeline accounting (engine/pipeline.py): finish-stage wall
    # that ran while later chunks were staged or executing, content-digest
    # dedupe savings and seconds (a part of pack_s here, of verify_s in
    # the hybrid's device pass), resident row-store hits, and the depth
    # the run used.
    h2d_overlap_s: float = 0.0
    dedupe_saved_bytes: int = 0
    dedupe_s: float = 0.0
    resident_hits: int = 0
    pipeline_depth: int = 0
    # Link accounting: padded chunk bytes before and after the codec, the
    # host encode time, and the full vs actually fetched D2H bytes.
    bytes_on_link_raw: int = 0
    bytes_on_link_coded: int = 0
    encode_s: float = 0.0
    d2h_bytes_raw: int = 0
    d2h_bytes: int = 0
    # The default engine's (engine/hybrid.py, engine/nfa_device.py), summed
    # over every call: the scanning thread blocked on the host pre-sieve,
    # and the device verify's lane assembly and dispatch (the
    # `sieve.wait`, `verify.assemble` and `verify.dispatch` spans' time),
    # and the lanes the assembly placed in stream rows.
    sieve_wait_s: float = 0.0
    verify_assemble_s: float = 0.0
    verify_dispatch_s: float = 0.0
    verify_assemble_lanes: int = 0
    # The multi-program pass (`scan_programs`), summed over every call: the
    # merged sieve (dedupe, pack, sieve, candidates), the claim-killer over
    # the verify columns, each stock program's resolve and, inside the
    # license resolve, its native fingerprints and B14 with its copies (the
    # `programs.*` and `license.*` spans' time); the license candidates, the
    # UTF-8 bytes fingerprinted, the rows B14 was given and its calls.
    program_sieve_s: float = 0.0
    program_verify_s: float = 0.0
    secret_resolve_s: float = 0.0
    license_resolve_s: float = 0.0
    license_fingerprint_s: float = 0.0
    license_classify_s: float = 0.0
    license_candidate_files: int = 0
    license_fingerprint_bytes: int = 0
    license_classify_rows: int = 0
    license_classify_calls: int = 0

    def phases(self) -> dict:
        out = {
            "pack_s": round(self.pack_s, 4),
            "sieve_s": round(self.sieve_s, 4),
            "candidate_s": round(self.candidate_s, 4),
            "confirm_s": round(self.confirm_s, 4),
        }
        if self.verify_s:
            out["verify_s"] = round(self.verify_s, 4)
        if self.h2d_s or self.exec_s:
            out["h2d_s"] = round(self.h2d_s, 4)
            out["exec_s"] = round(self.exec_s, 4)
        if self.pipeline_depth:
            out["pipeline_depth"] = self.pipeline_depth
            out["h2d_overlap_s"] = round(self.h2d_overlap_s, 4)
        if self.dedupe_saved_bytes:
            out["dedupe_saved_bytes"] = self.dedupe_saved_bytes
        if self.dedupe_s:
            out["dedupe_s"] = round(self.dedupe_s, 4)
        if self.resident_hits:
            out["resident_hits"] = self.resident_hits
        if self.bytes_on_link_raw:
            out["bytes_on_link_raw"] = self.bytes_on_link_raw
            out["bytes_on_link_coded"] = self.bytes_on_link_coded
            out["codec_ratio"] = round(
                self.bytes_on_link_coded / self.bytes_on_link_raw, 4
            )
        if self.encode_s:
            out["encode_s"] = round(self.encode_s, 4)
        if self.d2h_bytes_raw:
            out["d2h_bytes_raw"] = self.d2h_bytes_raw
            out["d2h_bytes"] = self.d2h_bytes
            out["d2h_ratio"] = round(self.d2h_bytes / self.d2h_bytes_raw, 4)
        return out
