"""Wall time of loading the reference, per million input reads: the
program's spans fasta.load (the FASTA parsed in `cli.py`, `io/fasta.py`),
genome.build (its contigs joined into one genome, `engine.py`) and
genome.upload (that genome mapped and sent to the device,
`engine._genome_dev`), summed over the window's samples. Every sample
pays all three: the CLI loads its reference anew on each run."""

from harness import spans

SOURCE = "program_span"
UNIT = "ms/Mread"
LAYER = "reference load (cli.py, io/fasta.py, engine._genome_dev)"
MOVES = "host_peak_rss_MB"
NAMES = ("fasta.load", "genome.build", "genome.upload")


def read(ctx):
    return spans.ms_per_mread(ctx, NAMES)
