"""Postgres protocol plane of the port: the CPU codecs (codec/), the
`ReplicationSource` contract (source.py), slot naming, source migrations
and the in-memory fake walsender (fake.py)."""
