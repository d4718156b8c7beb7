"""phfpfac_tpu_torch — PFAC multi-pattern string matching on CUDA GPUs.

The PyTorch/CUDA port of ``phfpfac_tpu``: the same host compiler
(newline-separated dictionary -> per-shard failureless Aho-Corasick
tables), one walker per input byte offset in hand-written CUDA kernels
(``csrc/``), and a gphf-compatible CLI writing a byte-identical
``GPU_match_result.txt`` (``phfpfac_tpu_torch.cli``).
"""

__version__ = "0.1.0"

from phfpfac_tpu_torch.compile.tables import (  # noqa: F401
    CompiledDictionary,
    ShardTables,
    compile_dictionary,
    compile_patterns,
)
from phfpfac_tpu_torch.frontend.patterns import (  # noqa: F401
    read_patterns,
    shard_patterns,
)
from phfpfac_tpu_torch.parallel.matcher import Matcher  # noqa: F401
from phfpfac_tpu_torch.parallel.stream import (  # noqa: F401
    StreamMatcher,
    match_many,
)
from phfpfac_tpu_torch.utils.config import PfacConfig  # noqa: F401
