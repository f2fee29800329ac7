"""Pair-parallel evaluation: the leading pair axis of the pair stage."""
