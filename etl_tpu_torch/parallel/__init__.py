"""Row-sharded decode across devices (`mesh.py`)."""
