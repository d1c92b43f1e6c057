from gencore_tpu_torch.io.bam import BamHeader, BamReader, BamWriter, RecordBatch
from gencore_tpu_torch.io.fasta import FastaRef
from gencore_tpu_torch.io.bed import BedRegions

__all__ = [
    "BamHeader", "BamReader", "BamWriter", "RecordBatch", "FastaRef", "BedRegions",
]
