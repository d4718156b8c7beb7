"""gphf-compatible command-line interface, on a CUDA device.

Usage (README.md:12 of the reference):

    python -m phfpfac_tpu_torch.cli <pattern file> <stream number> <hash table width> <input file>

Produces ``GPU_match_result.txt`` with lines
``At position %4d, match pattern %d`` (main.cc:335-350) plus the
reference's phase-timing taxonomy (main.cc:279-287) and PHF stats
(phf.c:262-282) on stdout.

Notes on fidelity:

* shard count = 4 * streamnum (create_table_reorder.c:207 hardcodes
  GPU_S = 4); ``--num-shards`` overrides.  The merged output is
  shard-count invariant.
* ``input_size = filesize - 1`` (main.cc:138 ``ftell(fpin)-1`` —
  assumes a trailing newline and drops it); ``--full-input`` disables
  the quirk.
* walk truncation defaults to the reference's 4 KiB segment + 512 B
  halo (master_kernel.cu:8-11); ``--exact`` removes the truncation.
* ``--device cpu`` runs the kernels' plain torch versions; the default
  is the CUDA device, and its absence is an error.
"""

from __future__ import annotations

import argparse
import os
import sys

from phfpfac_tpu_torch.compile.tables import compile_dictionary
from phfpfac_tpu_torch.parallel.matcher import Matcher, resolve_device
from phfpfac_tpu_torch.parallel.merge import render_result_file
from phfpfac_tpu_torch.utils.config import PfacConfig
from phfpfac_tpu_torch.utils.timing import PhaseTimer

# flags of paths the port does not have yet -> the ROADMAP.md item
_NOT_PORTED = {
    "charset": "queue 1, 'Serialization and --charset'",
    "save_tables": "queue 1, 'Serialization and --charset'",
    "load_tables": "queue 1, 'Serialization and --charset'",
    "profile": "queue 2, 'bench/ probes and tracing'",
    "mesh": "queue 1, 'Multi-GPU'",
    "coordinator": "queue 1, 'Multi-GPU'",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="gphf",
        description="PFAC multi-pattern matcher on a CUDA GPU "
                    "(PHFPFAC-compatible)",
    )
    p.add_argument("pattern_file")
    p.add_argument("streamnum", type=int, help="streams per device (shards = 4*streamnum)")
    p.add_argument("width", type=int, help="PHF hash table width (power of two)")
    p.add_argument("input_file")
    p.add_argument("-o", "--output", default="GPU_match_result.txt")
    p.add_argument("--num-shards", type=int, default=None,
                   help="override shard count (default 4*streamnum)")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda = the CUDA kernels (default); cpu = their "
                        "plain torch versions")
    p.add_argument("--engine", choices=["turbo", "jnp", "pallas"],
                   default="pallas",
                   help="pallas = the bitmap kernels (plan/depth); "
                        "turbo/jnp are not ported yet")
    p.add_argument("--exact", action="store_true",
                   help="disable reference segment+halo walk truncation")
    p.add_argument("--full-input", action="store_true",
                   help="scan all filesize bytes (reference scans filesize-1)")
    p.add_argument("--escapes", action="store_true",
                   help="decode \\xNN, \\ooo and C escapes in patterns (fgetc_ext)")
    p.add_argument("--charset", action="store_true",
                   help="charset classes in patterns (not ported yet)")
    p.add_argument("--save-tables", default=None,
                   help="serialize compiled tables (not ported yet)")
    p.add_argument("--load-tables", default=None,
                   help="load compiled tables (not ported yet)")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="trace the match phase (not ported yet)")
    mh = p.add_argument_group("multi-host (not ported yet)")
    mh.add_argument("--coordinator", default=None,
                    help="coordinator address host:port")
    mh.add_argument("--num-processes", type=int, default=1)
    mh.add_argument("--process-id", type=int, default=0)
    mh.add_argument("--mesh", action="store_true",
                    help="scan on a device mesh")
    return p


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.engine != "pallas":
        parser.error(f"--engine {args.engine} is not ported yet "
                     "(ROADMAP.md queue 1, 'XLA engines as torch ops')")
    for flag, item in _NOT_PORTED.items():
        if getattr(args, flag):
            parser.error(f"--{flag.replace('_', '-')} is not ported yet "
                         f"(ROADMAP.md {item})")
    if args.num_processes > 1:
        parser.error("--num-processes is not ported yet "
                     "(ROADMAP.md queue 1, 'Multi-GPU')")
    device = resolve_device(args.device)
    num_shards = args.num_shards or 4 * args.streamnum
    cfg = PfacConfig(
        width=args.width,
        num_shards=num_shards,
        truncation="none" if args.exact else "segment",
        match_slots=0,  # full parity layout
    )
    timer = PhaseTimer()

    with timer.phase("create_pfac"):
        compiled = compile_dictionary(
            args.pattern_file, cfg, escapes=args.escapes,
            verbose=not args.quiet,
        )

    for i, sh in enumerate(compiled.shards):
        if not args.quiet:
            # mirrors main.cc:113-117
            print(f"state num on shard {i} : {sh.state_num}")
            print(f"final state num on shard {i} : {sh.final_state_num}")
            print(f"max pattern length on shard {i} : {sh.max_pat_len}")

    file_size = os.path.getsize(args.input_file)
    input_size = file_size if args.full_input else max(file_size - 1, 0)
    if not args.quiet:
        print(f"input size is {input_size} char")  # main.cc:140

    with open(args.input_file, "rb") as f:
        data = f.read()
    matcher = Matcher(compiled, cfg, device=device, timer=timer)
    # big inputs scan in pipelined chunks (match_chunked falls through
    # to one-shot when small)
    text = render_result_file(
        matcher.match_chunked(data, input_size=input_size)
    )
    with open(args.output, "w") as f:
        f.write(text)

    if not args.quiet:
        print(timer.report())
        match_s = timer.phases.get("match")
        if match_s:
            # the reference's throughput line (older gphf binary;
            # commented out in current main.cc:285)
            print(
                f"The throughput is {input_size * 8 / match_s / 1e9:.6f} Gbps"
            )
    return 0


if __name__ == "__main__":
    sys.exit(main())
