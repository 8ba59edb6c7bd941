"""Serving (port of ``repro.serve``): the LM ``Engine``. ``CodecEngine``,
``ShardedCodecEngine`` and ``EngineHandle`` wait for the batcher and the
gateway (ROADMAP queue 1, item 5)."""

from repro_torch.serve.engine import Engine  # noqa: F401
