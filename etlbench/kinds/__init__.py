"""Kinds of traffic, one module each, found by the `kind` of a mix
(`spec.kind`): each gives `Driver` and `SUFFIX`."""
