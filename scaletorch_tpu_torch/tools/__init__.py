"""The operator's tools over the port, each run as ``python -m
scaletorch_tpu_torch.tools.<name>``: ``convert_layer_storage`` (a
checkpoint between stacked layer layouts), ``verify_weights`` (HF
checkpoints load, run forward and backward, and match ``transformers``),
``slo_check`` (the SLO gate over the gateway's telemetry),
``gateway_smoke`` (the serve entry end to end), ``group_hosts`` (a hosts
file in rack order) and ``launch_hosts`` (``launch`` over a hosts
file)."""
