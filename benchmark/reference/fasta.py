"""Reference FASTA loading.

The reference loads the entire uncompressed FASTA to RAM as 4-bit packed
contigs (src/fastareader.cpp:58-169). We load to per-contig uint8 arrays of
uppercase ASCII (unpacked — simpler gathers for the device ref-arbitration
path; hg-scale memory is fine host-side and the native core packs 2bit when
needed).

Reference-parity quirks preserved:
  * sequence characters kept: isalpha plus '-' and '*' (util.h:194-210);
  * lowercase forced to uppercase;
  * contig ID = header up to first space (fastareader.cpp:102-103);
  * --quit_after_contig stops after maxContig contigs (fastareader.cpp:164).
"""

from __future__ import annotations

import numpy as np


class FastaRef:
    def __init__(self, contigs: dict | None = None):
        # name -> np.uint8 array of ASCII bases
        self.contigs: dict = contigs or {}
        # Reference::getData cache + warning state machine
        # (reference.cpp:33-71), shared across the window pipeline's
        # engines (they share this FastaRef). The 'not found' warning is
        # one-shot (its static latch IS set, reference.cpp:51-56); the
        # length-mismatch warning prints on EVERY call that reaches the
        # check — that branch never sets its latch (reference.cpp:59-63,
        # a reference bug kept for stderr parity). Calls short-circuit
        # silently while the last successful lookup's contig is cached.
        self._warned_missing = False
        self._last_contig = None   # mLastBamContig analog
        self._last_ok = False      # mLastData != NULL analog

    def guard(self, name: str, len_ok: bool) -> bool:
        """One Reference::getData call: returns whether refdata is usable
        for (contig, len_ok = pos+len < contig size), emitting the
        reference's stderr warnings with its exact cadence."""
        if name == self._last_contig and self._last_ok:
            # cached-hit path: silent even on length failure, cache kept
            # (reference.cpp:39-44)
            return len_ok
        self._last_contig = name
        if name not in self.contigs:
            if not self._warned_missing:
                import sys
                print(f"contig {name} not found in the reference, please "
                      "make sure your reference is correct", file=sys.stderr)
            self._warned_missing = True
            self._last_ok = False
            return False
        if not len_ok:
            import sys
            print(f"contig {name} doesn't match the length in the "
                  "reference, please make sure your reference is correct",
                  file=sys.stderr)
            self._last_ok = False
            return False
        self._last_ok = True
        return True

    @classmethod
    def load(cls, path: str, max_contig: int = 0) -> "FastaRef":
        contigs = {}
        name = None
        parts = []
        with open(path, "rb") as f:
            for line in f:
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        contigs[name] = _join_seq(parts)
                    # reference stops once size exceeds maxContig, i.e. it
                    # keeps maxContig+1 contigs (fastareader.cpp:164)
                    if max_contig > 0 and len(contigs) > max_contig:
                        name = None
                        break
                    header = line[1:].decode()
                    name = header.split(" ")[0]
                    parts = []
                elif name is not None:
                    parts.append(line)
            if name is not None:
                contigs[name] = _join_seq(parts)
        return cls(contigs)

    def get_contig(self, name: str):
        return self.contigs.get(name)

    def base_at(self, name: str, pos: int) -> str:
        c = self.contigs[name]
        return chr(c[pos])

    def contig_len(self, name: str) -> int:
        c = self.contigs.get(name)
        return 0 if c is None else len(c)


_VALID = np.zeros(256, dtype=bool)
for ch in range(ord("A"), ord("Z") + 1):
    _VALID[ch] = True
for ch in range(ord("a"), ord("z") + 1):
    _VALID[ch] = True
_VALID[ord("-")] = True
_VALID[ord("*")] = True
_LOWER_TO_UPPER = np.arange(256, dtype=np.uint8)
_LOWER_TO_UPPER[ord("a"):ord("z") + 1] = np.arange(ord("A"), ord("Z") + 1, dtype=np.uint8)


def _join_seq(parts: list) -> np.ndarray:
    raw = np.frombuffer(b"".join(parts), dtype=np.uint8)
    raw = raw[_VALID[raw]]
    return _LOWER_TO_UPPER[raw]
