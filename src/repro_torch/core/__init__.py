from repro_torch.core import attention, cache, flex, paging
from repro_torch.core.paging import HostPageManager

__all__ = ["attention", "cache", "flex", "paging", "HostPageManager"]
