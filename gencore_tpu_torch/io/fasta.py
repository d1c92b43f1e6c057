"""Reference FASTA loading.

The reference loads the entire uncompressed FASTA to RAM as 4-bit packed
contigs (src/fastareader.cpp:58-169). We load to uppercase ASCII (unpacked —
simpler gathers for the device ref-arbitration path), every contig in one
uint8 buffer, `FastaRef.genome`, back to back in the contigs' order; each
entry of `FastaRef.contigs` is a view into it. The native core
(io/native.py) parses the file in two chunked passes, counting each
contig's bases and then writing them into the buffer sized from the
counts, so the genome is only ever held once; without the native core the
lines are joined in Python and copied into the buffer.

Reference-parity quirks preserved:
  * sequence characters kept: isalpha plus '-' and '*' (util.h:194-210);
  * lowercase forced to uppercase;
  * contig ID = header up to first space (fastareader.cpp:102-103);
  * --quit_after_contig stops after maxContig contigs (fastareader.cpp:164).
"""

from __future__ import annotations

import itertools

import numpy as np


class FastaRef:
    def __init__(self, genome: np.ndarray, names: list, lengths: list,
                 load_info: dict):
        """`names`' contigs, lengths[i] bases each, lie back to back in
        `genome` in that order. load_info: how the file was read
        (bytes_read, contigs, native 0 or 1)."""
        starts = [0, *itertools.accumulate(lengths)]
        self.genome = genome
        self.offset = dict(zip(names, starts))
        # name -> np.uint8 array of ASCII bases, a view of `genome`
        self.contigs: dict = {n: genome[a:b] for n, a, b
                              in zip(names, starts, starts[1:])}
        self.load_info = load_info
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
        from gencore_tpu_torch.io import native
        scan = native.fasta_scan(path)
        if scan is None:
            return cls._load_lines(path, max_contig)
        kept, headers, size = scan
        # record r >= 1 is the r-th header's contig (record 0, what comes
        # before the first header, is dropped); a repeated name takes the
        # later sequence at the first one's place in the dict
        winner = {}
        for r in range(1, len(kept)):
            winner[_name(headers[r])] = r
            # the reference stops once size exceeds maxContig, i.e. it
            # keeps maxContig+1 contigs (fastareader.cpp:164)
            if max_contig > 0 and len(winner) > max_contig:
                break
        recs = list(winner.values())
        lengths = kept[recs].tolist()
        dest = np.full(len(kept), -1, dtype=np.int64)
        dest[recs] = [0, *itertools.accumulate(lengths)][:-1]
        genome = np.empty(sum(lengths), dtype=np.uint8)
        size += native.fasta_fill(path, dest, kept, genome)
        return cls(genome, list(winner), lengths,
                   {"bytes_read": size, "contigs": len(winner), "native": 1})

    @classmethod
    def _load_lines(cls, path: str, max_contig: int) -> "FastaRef":
        """The loader without the native core: line by line in Python."""
        contigs = {}
        name = None
        parts = []
        size = 0
        with open(path, "rb") as f:
            for line in f:
                size += len(line)
                line = line.rstrip(b"\r\n")
                if line.startswith(b">"):
                    if name is not None:
                        contigs[name] = _join_seq(parts)
                    # reference stops once size exceeds maxContig, i.e. it
                    # keeps maxContig+1 contigs (fastareader.cpp:164)
                    if max_contig > 0 and len(contigs) > max_contig:
                        name = None
                        break
                    name = _name(line[1:])
                    parts = []
                elif name is not None:
                    parts.append(line)
            if name is not None:
                contigs[name] = _join_seq(parts)
        genome = np.concatenate([np.zeros(0, dtype=np.uint8),
                                 *contigs.values()])
        return cls(genome, list(contigs), [len(c) for c in contigs.values()],
                   {"bytes_read": size, "contigs": len(contigs), "native": 0})

    def joined(self, names) -> np.ndarray | None:
        """The contigs `names` (absent ones empty) joined in that order, as
        a view of `genome` where they lie back to back in it; else None."""
        start = end = None
        for n in names:
            c = self.contigs.get(n)
            if c is None or not len(c):
                continue
            if end is None:
                start = end = self.offset[n]
            elif self.offset[n] != end:
                return None
            end += len(c)
        return self.genome[start:end] if start is not None else self.genome[:0]

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


def _name(header: bytes) -> str:
    """Contig ID: the header up to its first space (fastareader.cpp:102-103)."""
    return header.decode().split(" ")[0]


def _join_seq(parts: list) -> np.ndarray:
    raw = np.frombuffer(b"".join(parts), dtype=np.uint8)
    raw = raw[_VALID[raw]]
    return _LOWER_TO_UPPER[raw]
