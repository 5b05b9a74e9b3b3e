"""Destinations, one module each, found by the `destination` of a mix
(`spec.destination`): each gives `make(span)`."""
