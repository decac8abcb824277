"""Alignment engine: scoring, MAPQ, the fused single-end step (pipeline)
and SAM emission (emit)."""
