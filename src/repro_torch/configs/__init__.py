"""Paper architecture configs (port of ``repro.configs``' paper subset)."""

from repro_torch.configs.paper import get as get_paper_config  # noqa: F401
