"""Static-analysis markers the runtime carries (copy of the reference's
`etl_tpu/analysis/annotations.py`; the analyzer itself is not ported)."""
