"""Stand-ins for the program's CLI that break it underneath, for the tests
that see `correct` come out false, and the control: the reference put in
the program's place with its base qualities held in four bits."""

from __future__ import annotations

import shutil

from harness import check


def _args(argv):
    return {k: argv[argv.index(k) + 1] for k in ("-i", "-o", "-j", "-r", "-b")}


def _rewrite(path: str, keep):
    """Rewrite a BAM's records through keep(i, body) -> body or None."""
    from reference import bam as bamio
    from reference import bgzf
    r = bamio.BamReader(path)
    b = r.read_all()
    out = [r.header.encode()]
    for i in range(b.n):
        body = keep(i, b.record_bytes(i))
        if body is not None:
            out.append(len(body).to_bytes(4, "little") + body)
    bgzf.compress_to_file(path, b"".join(out))


def altered_answer(main):
    """The program, with one base of one consensus record changed where
    the output is written."""
    def run(argv):
        rc = main(argv)
        def flip(i, body):
            if i != 7:
                return body
            body = bytearray(body)
            lrn, ncig = body[8], int.from_bytes(body[12:14], "little")
            at = 32 + lrn + 4 * ncig
            body[at] = ((body[at] >> 4) % 8 + 1) << 4 | (body[at] & 15)
            return bytes(body)
        _rewrite(_args(argv)["-o"], flip)
        return rc
    return run


def half_left_out(main):
    """The program, with every other output record left out."""
    def run(argv):
        rc = main(argv)
        _rewrite(_args(argv)["-o"], lambda i, body: body if i % 2 else None)
        return rc
    return run


def state_unchanged(main):
    """The program whose consensus step hands back its input unchanged:
    the output is the input's records."""
    def run(argv):
        rc = main(argv)
        a = _args(argv)
        shutil.copyfile(a["-i"], a["-o"])
        return rc
    return run


def control(workers: int = 2):
    """The reference in the program's place, its base qualities held in
    four bits (each phred value's low two bits dropped as it is read): the
    nearest narrower storage of a quality than the byte gencore votes
    with. It writes the output BAM and JSON report as the CLI does."""
    def run(argv):
        from reference import bam as bamio
        from reference import bgzf
        a = _args(argv)
        cli = argv[argv.index("--device") + 2:]
        header = bamio.BamReader(a["-i"]).header
        starts = check.bed_starts(a["-b"], header.names)
        recs, report = check.reference(a["-i"], a["-r"], a["-b"], cli, starts,
                                       workers, qual_shift=2)
        payload = [header.encode()] + [len(r).to_bytes(4, "little") + r for r in recs]
        bgzf.compress_to_file(a["-o"], b"".join(payload))
        with open(a["-j"], "w") as f:
            f.write("\n".join(report + ['\t"command": "control"']) + "\n}")
        # the line the harness reads of every sample, as the CLI prints it
        import sys
        print("I/O: native core (control), streaming path", file=sys.stderr)
        return 0
    return run
