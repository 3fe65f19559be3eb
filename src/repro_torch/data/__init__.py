from repro_torch.data.pipeline import (
    DataConfig, FileSource, PrefetchIterator, SyntheticSource,
)

__all__ = ["DataConfig", "FileSource", "PrefetchIterator", "SyntheticSource"]
