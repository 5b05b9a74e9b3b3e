"""The port's runnable examples, each a module:

    python -m etl_tpu_torch.examples.lake_pipeline [--device cpu]
    python -m etl_tpu_torch.examples.iceberg_pipeline [--device cpu]
    python -m etl_tpu_torch.examples.control_plane [--port N]

and `config/base.yaml`, a replicator config the port's loader takes
(`python -m etl_tpu_torch.replicator --config-dir
etl_tpu_torch/examples/config`). The pipelines decode on the card (the
CUDA engine) unless they are given `--device cpu`; each `main()` returns
what it prints.
"""

from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parent / "config"

#: the keys of a replicator config the binary reads itself
#: (`replicator.run_replicator`); the rest is its PipelineConfig
REPLICATOR_KEYS = ("destination", "store", "maintenance", "metrics_port",
                   "project_ref", "error_webhook_url")


def load_example_config(config_dir=CONFIG_DIR, environ=None) -> tuple:
    """(PipelineConfig, the replicator's own sections) of a config
    directory, through the port's loader: the example's `batch_engine:
    cuda` loads as `BatchEngine.CUDA`; the reference's `tpu` is refused
    with CONFIG_INVALID."""
    from ..config.load import load_config_dict, pipeline_config_from_dict

    doc = load_config_dict(config_dir, environ=environ)
    rest = {k: doc.pop(k) for k in REPLICATOR_KEYS if k in doc}
    return pipeline_config_from_dict(doc), rest
