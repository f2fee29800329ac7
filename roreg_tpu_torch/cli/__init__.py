"""Command-line entry points: evaluation (``test``), descriptor extraction (``testset``) and the one-pair demo (``demo``)."""
