"""The paper's own system config: UPMEM-PIM allocator parameters (Table 3)."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class PaperConfig:
    heap_bytes: int = 32 * 1024 * 1024
    min_block: int = 32
    block_bytes: int = 4096
    size_classes: tuple = (16, 32, 64, 128, 256, 512, 1024, 2048)
    num_threads: int = 16          # evaluated at 1 and 16 tasklets
    n_cores: int = 512             # UPMEM system in Sec. 5
    buddy_cache_bytes: int = 64    # 16 entries x 4 B
    freq_hz: float = 350e6


CONFIG = PaperConfig()
