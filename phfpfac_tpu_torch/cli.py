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
* ``--engine turbo|jnp`` scan with torch ops instead of the kernels.
* ``--save-tables`` writes the compiled dictionary (``.npz``) at once
  and, after a kernel-engine scan, again with the plan tables that scan
  built (format v3); ``--load-tables`` then skips the trie and plan
  builds.  The files are interchangeable with the JAX package's.
* ``--charset`` reads ``[a-z]`` / ``[^...]`` classes in the patterns.
* ``--mesh`` scans on a (data x patterns) mesh of every visible CUDA
  device (one cell with ``--device cpu``): the plan-kernel mesh, or the
  turbo mesh where the plan tables refuse the dictionary.
  ``--coordinator HOST:PORT --num-processes N --process-id I`` run N
  cooperating processes (``torch.distributed``, gloo), each reading and
  scanning its slice of the input file on its own mesh; process 0
  writes the result file.  Neither re-saves plan tables under
  ``--save-tables``.
* ``--profile DIR`` writes a ``torch.profiler`` Chrome trace of the
  match phase into DIR (CUDA and CPU activities; CPU alone with
  ``--device cpu``).
"""

from __future__ import annotations

import argparse
import contextlib
import os
import sys

from phfpfac_tpu_torch.compile.tables import (
    CompiledDictionary,
    compile_class_patterns,
    compile_dictionary,
)
from phfpfac_tpu_torch.frontend.charset import read_class_patterns
from phfpfac_tpu_torch.parallel.matcher import Matcher, resolve_device
from phfpfac_tpu_torch.parallel.merge import render_result_file
from phfpfac_tpu_torch.utils.config import PfacConfig
from phfpfac_tpu_torch.utils.timing import PhaseTimer


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
                   help="pallas = the hand-written CUDA kernels "
                        "(plan/pair/depth, banked-PHF), in 16 MiB chunks; "
                        "turbo = the torch-op table walk with survivor "
                        "compaction; jnp = the dense torch-op walk with "
                        "[positions, max pattern length] match rows "
                        "(both scan the input in one piece)")
    p.add_argument("--exact", action="store_true",
                   help="disable reference segment+halo walk truncation")
    p.add_argument("--full-input", action="store_true",
                   help="scan all filesize bytes (reference scans filesize-1)")
    p.add_argument("--escapes", action="store_true",
                   help="decode \\xNN, \\ooo and C escapes in patterns (fgetc_ext)")
    p.add_argument("--charset", action="store_true",
                   help="enable [a-z] / [^...] charset classes in patterns "
                        "(NFA->DFA frontend; shards like plain dicts)")
    p.add_argument("--save-tables", default=None,
                   help="serialize compiled tables to this .npz path")
    p.add_argument("--load-tables", default=None,
                   help="load compiled tables instead of building")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the match phase")
    mh = p.add_argument_group("multi-process (torch.distributed, gloo)")
    mh.add_argument("--coordinator", default=None,
                    help="coordinator address host:port")
    mh.add_argument("--num-processes", type=int, default=1)
    mh.add_argument("--process-id", type=int, default=0)
    mh.add_argument("--mesh", action="store_true",
                    help="scan on a (data x patterns) device mesh even "
                         "single-process (all visible CUDA devices)")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    on_mesh = args.num_processes > 1 or args.mesh
    if args.num_processes > 1:
        from phfpfac_tpu_torch.parallel import distributed

        distributed.initialize(args.coordinator, args.num_processes,
                               args.process_id)
    num_shards = args.num_shards or 4 * args.streamnum
    cfg = PfacConfig(
        width=args.width,
        num_shards=num_shards,
        truncation="none" if args.exact else "segment",
        match_slots=0,  # full parity layout
    )
    timer = PhaseTimer()

    with timer.phase("create_pfac"):
        if args.load_tables:
            compiled = CompiledDictionary.load(args.load_tables)
        elif args.charset:
            compiled = compile_class_patterns(
                read_class_patterns(args.pattern_file), cfg
            )
        else:
            compiled = compile_dictionary(
                args.pattern_file, cfg, escapes=args.escapes,
                verbose=not args.quiet,
            )
    # save at once (a failed scan must not cost the compile); a
    # kernel-engine run saves again after the scan, so that the plan
    # tables it built ride along and a later --load-tables run skips the
    # trie + plan build
    if args.save_tables:
        compiled.save(args.save_tables)

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

    prof = contextlib.nullcontext()
    if args.profile:
        from phfpfac_tpu_torch.utils.profile import trace

        prof = trace(args.profile, device=device)

    if on_mesh:
        from phfpfac_tpu_torch.parallel.distributed import MultiHostMatcher

        mh = MultiHostMatcher(compiled, cfg, device=device)
        with prof, timer.phase("match"):
            matches = mh.match_file(args.input_file, input_size=input_size)
        text = render_result_file(matches)
        write_out = args.process_id == 0
        if args.num_processes > 1:
            distributed.finalize()
    else:
        with open(args.input_file, "rb") as f:
            data = f.read()
        matcher = Matcher(compiled, cfg, engine=args.engine, device=device,
                          timer=timer)
        with prof:
            # big inputs scan in pipelined chunks (match_chunked falls
            # through to one-shot when small)
            text = render_result_file(
                matcher.match_chunked(data, input_size=input_size)
            )
        if args.save_tables and args.engine == "pallas":
            plan = matcher.built_plan_tables()
            if any(p is not None for p in plan):
                compiled.plan_tables = plan
                compiled.save(args.save_tables)
        write_out = True
    if write_out:
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
