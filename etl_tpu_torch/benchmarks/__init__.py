"""The benchmark harness: the reference's `etl_tpu/benchmarks` modes on the
port's pipeline (`harness`), the K-process shard worker (`shard_worker`)
and the report diff (`compare`). `python -m etl_tpu_torch.bench` calls
into it for its `--ack-latency`, `--poison`, `--exactly-once`,
`--workload`, `--multi-pipeline`, `--sharded`, `--mode lag`, `--mode
wide_row` and `--smoke` flags."""
