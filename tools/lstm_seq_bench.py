"""Time the whole-sequence LSTM kernels on the card across launch shapes.

    python3 tools/lstm_seq_bench.py [--out chiprun_out/lstm_seq_bench.json]

For each cluster size (the CTAs that share Wh) and largest batch tile (rows
per cluster), the forward and the reverse scan of ``csrc/lstm_seq.cu`` at
the forecaster's shapes (B 8: encoder T 672 with I 10, decoder T 96 with
I 9; H 128) and at an evaluation batch (B 256, T 672), one call back to
back by CUDA events; the per-step cost of an almost empty scan (B 1, I 1,
H 16); and cuDNN's ``torch.lstm`` on the same inputs.  Every launch shape
must give the forward's bits (each column's sum runs in one fixed order),
and every tile of one cluster size the backward's.
Needs one CUDA card; prints one JSON object, then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(REPO / "src"), str(REPO)]

SHAPES = {"encoder": (8, 10, 672), "decoder": (8, 9, 96),
          "eval": (256, 10, 672)}           # B, I, T
LAUNCH = [(8, 4), (8, 8), (8, 2), (4, 4), (2, 4)]    # cluster, max tile


def main() -> int:
    import torch

    from chip_smoke import card_line, cuda_ms, cudnn_lstm, seq_inputs
    from repro_torch.kernels.lstm_cell import ops

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("lstm_seq_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {k: seq_inputs("cuda", gen, b, i, t, 128)
              for k, (b, i, t) in SHAPES.items()}
    tiny = seq_inputs("cuda", gen, 1, 1, 672, 16)
    order, tile = ops.CLUSTER_ORDER, ops.SEQ_MAX_TILE
    rows, first = [], {}
    try:
        for cs, max_tile in LAUNCH:
            ops.CLUSTER_ORDER, ops.SEQ_MAX_TILE = (cs,), max_tile
            row = {"cluster": cs, "max_tile": max_tile}
            for name, a in inputs.items():
                fwd = ops.lstm_seq_fwd(*a)
                bargs = (None, a[1], a[2], fwd[2], fwd[1], a[2], a[4])
                bwd = ops.lstm_seq_bwd(*bargs)
                # the forward's bits are the same for every launch shape;
                # the backward adds the CTAs' partials, so its bits are
                # the same for every tile of one cluster size
                key = first.setdefault(name, fwd)
                kb = first.setdefault((name, cs), bwd)
                if not all(torch.equal(x, y) for x, y in
                           zip((*fwd, *bwd), (*key, *kb))):
                    raise SystemExit(f"cluster {cs}, tile {max_tile}, {name}: "
                                     "other bits than the first launch shape")
                row[f"{name}_fwd_ms"] = cuda_ms(lambda: ops.lstm_seq_fwd(*a),
                                                iters=20, warmup=3)
                row[f"{name}_bwd_ms"] = cuda_ms(
                    lambda: ops.lstm_seq_bwd(*bargs), iters=20, warmup=3)
            if cs <= 4:
                row["tiny_step_us"] = cuda_ms(
                    lambda: ops.lstm_seq_fwd(*tiny, save=False), iters=20,
                    warmup=3) / 672 * 1e3
            rows.append(row)
            print(json.dumps(row))
    finally:
        ops.CLUSTER_ORDER, ops.SEQ_MAX_TILE = order, tile
    cudnn = {}
    for name, a in inputs.items():
        _, call = cudnn_lstm(a)
        cudnn[f"{name}_fwd_ms"] = cuda_ms(call, iters=20, warmup=3)
    result = {"launch_shapes": rows, "cudnn": cudnn, "card": card_line()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
