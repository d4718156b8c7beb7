"""Engine selection for benchmark/serving entry points.

``best_count_scanner`` returns the fastest available count-mode scan
for one shard: a hand-written kernel when its table build takes the
shard, else the full-width torch-op scan.
"""

from __future__ import annotations

from phfpfac_tpu_torch.compile.tables import ShardTables
from phfpfac_tpu_torch.ops.common import resolve_device
from phfpfac_tpu_torch.ops.staging import to_device_bytes
from phfpfac_tpu_torch.ops.turbo import build_turbo_tables, scan_core


def xla_count_scanner(shard: ShardTables, max_steps: int, *, device=None):
    """Count-mode scan: the turbo engine's walk at full width for every
    step, exact mode (the counterpart of the JAX package's XLA
    fori-loop scan, over the same guarded tables: every gather is in
    bounds by construction).

    Returned fn(data_padded_u8[n_pos+max_steps], input_size, shift)
    -> int64 [1] total match count over positions [shift, input_size).
    ``shift`` exists so benchmark harnesses can chain calls with
    distinct computations.
    """
    tt = build_turbo_tables(shard)
    device = resolve_device(device)

    def scan(data, input_size, shift):
        _rows, cnt, *_tail = scan_core(
            to_device_bytes(data, device), 0, *tt.on(device),
            int(input_size), tt.width_bit, tt.row_bits, tt.dead,
            tt.num_final, 0, 0, max_steps=max_steps, full_steps=max_steps,
            cap=0, emit_counts=True)
        return cnt[int(shift):].sum().reshape(1)

    return scan


def best_count_scanner(shard: ShardTables, max_steps: int,
                       train: bytes | None = None, *, device=None):
    """Fastest available count-mode scan for one shard.

    Preference order: cost-planned hybrid-stride kernel (ops.plan —
    compact alphabets) > stride-2 pair kernel > depth-stratified kernel
    (any leveled automaton, max_pat_len <= 32) > banked-PHF kernel >
    torch-op scan.  ``train`` is an optional profile corpus for the plan
    kernel's profile-trained layout (exact for any input).  A table build
    refuses a shard with DepthUnsupported (PairUnsupported is one) or
    PhfUnsupported; any other error is a fault and propagates.
    """
    device = resolve_device(device)
    from phfpfac_tpu_torch.compile.depth import DepthUnsupported
    from phfpfac_tpu_torch.ops.depth import depth_count_scanner
    from phfpfac_tpu_torch.ops.pair import pair_count_scanner
    from phfpfac_tpu_torch.ops.plan import plan_count_scanner
    from phfpfac_tpu_torch.ops.scan import PhfUnsupported, pallas_count_scanner

    makers = (
        lambda: plan_count_scanner(shard, max_steps, device=device,
                                   train=train),
        lambda: pair_count_scanner(shard, max_steps, device=device),
        lambda: depth_count_scanner(shard, max_steps, device=device),
        lambda: pallas_count_scanner(shard, max_steps, device=device),
    )
    for make in makers:
        try:
            return make()
        except (DepthUnsupported, PhfUnsupported):
            continue  # the table build refused this shard
    return xla_count_scanner(shard, max_steps, device=device)
