"""Run configuration for the consensus engine.

Mirrors the reference Options POD (reference: src/options.h:15-61,
src/options.cpp:4-111) including defaults and validation ranges, plus
TPU-specific knobs (device batching / sharding) that have no reference
counterpart.
"""

from __future__ import annotations

import dataclasses


class OptionError(ValueError):
    """Raised for out-of-range options (reference hard-exits, options.cpp:42-111)."""


@dataclasses.dataclass
class Options:
    # I/O (reference: src/options.h:21-34)
    input: str = ""
    output: str = ""
    ref_file: str = ""
    bed_file: str = ""
    umi_prefix: str = "auto"
    report_title: str = "gencore report"
    max_contig: int = 0            # --quit_after_contig
    debug: bool = False
    has_bed_file: bool = False
    json_file: str = "gencore.json"
    html_file: str = "gencore.html"

    # thresholds (reference: src/options.cpp:12-31)
    proper_reads_umi_diff_threshold: int = 1     # --umi_diff_threshold
    unproper_reads_umi_diff_threshold: int = 0   # not CLI-exposed
    duplex_mismatch_threshold: int = 2           # --duplex_diff_threshold
    cluster_size_req: int = 1                    # --supporting_reads
    base_score_req: int = 6                      # --score_threshold
    score_percent_req: float = 0.8               # --ratio_threshold

    # quality tiers (reference: src/options.cpp:21-23)
    high_quality: int = 30
    moderate_quality: int = 20
    low_quality: int = 15

    # per-base scores for non-overlapped positions (reference: src/options.cpp:25-28)
    score_not_overlapped_high_qual: int = 8
    score_not_overlapped_moderate_qual: int = 6
    score_not_overlapped_low_qual: int = 4
    score_not_overlapped_bad_qual: int = 2

    # low-complexity cluster skip (reference: src/options.cpp:31)
    skip_low_complexity_cluster_threshold: int = 1000

    # coverage sampling (reference: src/options.cpp:35-36)
    bed_coverage_step: int = 10    # unused by the reference as well
    coverage_step: int = 10000     # --coverage_sampling

    duplex_only: bool = False      # --duplex_only
    disable_duplex: bool = False   # --no_duplex

    # ---- TPU-native engine knobs (no reference counterpart) ----
    # halo: same-contig pairs are bounded at 100kb (gencore.cpp:300)
    pair_gap_limit: int = 100_000
    # device batching
    max_read_len: int = 0          # 0 = auto from data
    device_batch_jobs: int = 2048  # consensus jobs per device dispatch
    use_device: bool = True        # False = pure numpy compute path (debugging)

    def validate(self) -> "Options":
        """Range checks; mirrors reference src/options.cpp:42-111."""
        if self.score_percent_req > 1.0:
            raise OptionError("ratio_threshold cannot be greater than 1.0")
        if self.score_percent_req < 0.5:
            raise OptionError("ratio_threshold cannot be less than 0.5")
        if self.cluster_size_req > 10:
            raise OptionError("supporting_reads cannot be greater than 10")
        if self.cluster_size_req < 1:
            raise OptionError("supporting_reads cannot be less than 1")
        if self.base_score_req > 10:
            raise OptionError("score_threshold cannot be greater than 10")
        if self.base_score_req < 1:
            raise OptionError("score_threshold cannot be less than 1")
        if self.high_quality > 40:
            raise OptionError("high_qual cannot be greater than 40")
        if self.high_quality < 20:
            raise OptionError("high_qual cannot be less than 20")
        if self.moderate_quality > 35:
            raise OptionError("moderate_qual cannot be greater than 35")
        if self.moderate_quality < 15:
            raise OptionError("moderate_qual cannot be less than 15")
        if self.low_quality > 30:
            raise OptionError("low_qual cannot be greater than 30")
        if self.low_quality < 8:
            raise OptionError("low_qual cannot be less than 8")
        if self.proper_reads_umi_diff_threshold > 10:
            raise OptionError("umi_diff_threshold cannot be greater than 10")
        if self.proper_reads_umi_diff_threshold < 0:
            raise OptionError("umi_diff_threshold cannot be negative")
        if self.low_quality > self.moderate_quality:
            raise OptionError("low_qual cannot be greater than moderate_qual")
        if self.moderate_quality > self.high_quality:
            raise OptionError("moderate_qual cannot be greater than high_qual")
        if self.duplex_mismatch_threshold > 10:
            raise OptionError("duplex_diff_threshold cannot be greater than 10, suggest 2.")
        if self.duplex_mismatch_threshold < 0:
            raise OptionError("duplex_diff_threshold cannot be less than 0, suggest 2.")
        if self.duplex_only and self.disable_duplex:
            raise OptionError("You cannot enable both duplex_only and no_duplex")
        return self
