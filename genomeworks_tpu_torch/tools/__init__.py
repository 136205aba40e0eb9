"""Command-line tools of the port: ``gw_poa`` (consensus / MSA),
``gw_mapper`` (overlaps to PAF, SAM or BAM), ``evaluate_paf``,
``genome_simulator`` and ``alignment_visualizer``."""
