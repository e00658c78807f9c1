#!/usr/bin/env python3
"""Where bf16 greedy decode on the port parts between two batch
compositions (ROADMAP.md C4), on one GPU:

    python3 scripts/torch_c4_isolation.py [--out FILE]

It serves ``chip_smoke.py``'s engine traffic (llama3-8b at full width,
random bf16 weights from its seed, 8 requests of 17..1000 prompt tokens,
32 new tokens each, greedy, burst 8) once as one batch, then each request
alone on a fresh engine, and records for every generated token the f32
logits row that chose it and the path that computed it: a mixed step
(``ragged_forward``: the paged prefill kernel B4, GEMMs over the padded
256-token step) or a decode body (the paged decode kernel B5, GEMMs over
the 8 table rows).  Per request it prints the first token whose logits
differ between the two runs, both paths there, the largest logit
difference, and the first token that differs.  For the first request that
parts, it recomputes that token in both runs with every decoder layer's
output captured and prints the first layer that differs and by how much.

A difference that first appears where the two runs took different paths
(B4 at M = 256 against B5 at M = 8) is a design difference: the kernels
and cuBLAS sum in another order.  One that appears where both runs took
a decode body on identical inputs is a leak between rows (a fault).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args()

    import numpy as np
    import torch

    import chip_smoke as cs
    from deepspeed_tpu_torch.inference.v2 import engine as te
    from deepspeed_tpu_torch.models import transformer as tfm

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is false: this needs an NVIDIA "
                "GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card_line())
    cfg = tfm.get_config("llama3-8b")
    params = tfm.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(cs.SEED),
        device="cuda")
    v2 = te.V2Config(max_tokens_per_step=256, max_seqs=8,
                     block_size=cs.BS, num_blocks=cs.NB,
                     max_blocks_per_seq=cs.MB, dtype="bfloat16")
    rng = np.random.default_rng(cs.SEED)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in cs.PROMPT_LENS]

    # every decoder layer's output, captured while ``capture`` is set
    layer, capture = te._layer, {"on": False, "xs": []}

    def layer_(*a, **kw):
        x = layer(*a, **kw)
        if capture["on"]:
            capture["xs"].append(x.detach().clone())
        return x

    te._layer = layer_

    def serve(which):
        """Serve ``prompts[i] for i in which`` together; per request the
        list of (token, path, f32 logits row on the CPU, forward index,
        row of that forward)."""
        eng = te.InferenceEngineV2(cfg, params, v2)
        uids = {eng.put(prompts[i], max_new_tokens=cs.NEW_TOKENS): i
                for i in which}
        rec = {i: [] for i in which}
        state = {"fwd": 0, "rows": []}
        build, decode, step = eng.builder.build, eng._decode, eng.step

        def build_(picks):
            batch = build(picks)
            state["rows"] = batch.uids
            return batch

        def decode_(*a, **kw):
            logits = decode(*a, **kw)
            t = eng.table
            for r in np.nonzero(t.active)[0]:
                uid = t.seq_at[int(r)].uid
                rec[uids[uid]].append(
                    ("decode", logits[int(r)].float().cpu(), state["fwd"],
                     int(r)))
            state["fwd"] += 1
            return logits

        def step_(*a, **kw):
            mixed = bool(eng.waiting or eng._prefilling)
            fwd = state["fwd"]
            out = step(*a, **kw)
            if mixed:
                state["fwd"] += 1
                for uid in out:
                    row = state["rows"].index(uid)
                    rec[uids[uid]].append(
                        ("mixed", eng.last_logits[row].cpu(), fwd, row))
            return out

        eng.builder.build, eng._decode, eng.step = build_, decode_, step_
        res = eng.generate_all(burst=8)
        out = {}
        for uid, i in uids.items():
            toks = res[uid][len(prompts[i]):]
            out[i] = [(tok,) + r for tok, r in zip(toks, rec[i])]
        return out

    def layer_outputs(which, fwd_index, row_of):
        """Every layer's output row for one forward of a fresh run of
        ``which`` (``row_of(batch_or_None) -> row``)."""
        eng = te.InferenceEngineV2(cfg, params, v2)
        for i in which:
            eng.put(prompts[i], max_new_tokens=cs.NEW_TOKENS)
        n = {"fwd": 0, "batch": None}
        build, decode, step = eng.builder.build, eng._decode, eng.step

        def arm():
            capture["on"] = n["fwd"] == fwd_index
            capture["xs"] = [] if capture["on"] else capture["xs"]

        def build_(picks):
            n["batch"] = build(picks)
            return n["batch"]

        def decode_(*a, **kw):
            arm()
            n["batch"] = None
            out = decode(*a, **kw)
            capture["on"] = False
            n["fwd"] += 1
            return out

        def step_(*a, **kw):
            if eng.waiting or eng._prefilling:
                arm()
                out = step(*a, **kw)
                capture["on"] = False
                n["fwd"] += 1
                return out
            return step(*a, **kw)

        eng.builder.build, eng._decode, eng.step = build_, decode_, step_
        while n["fwd"] <= fwd_index and (eng.waiting or eng.running):
            eng.step() if (eng.waiting or eng._prefilling) else \
                eng._burst_decode(1)
        row = row_of(n["batch"])
        return [x[row].float().cpu() for x in capture["xs"]]

    batch = serve(range(len(prompts)))
    alone = {i: serve([i])[i] for i in range(len(prompts))}
    report, first_parted = [], None
    for i in range(len(prompts)):
        a, b = batch[i], alone[i]
        diffs = [(ra[2] - rb[2]).abs().max().item() for ra, rb in zip(a, b)]
        first_logit = next((t for t, d in enumerate(diffs) if d > 0), None)
        first_token = next((t for t, (ra, rb) in enumerate(zip(a, b))
                            if ra[0] != rb[0]), None)
        entry = {"request": i, "prompt_tokens": len(prompts[i]),
                 "paths_batch": "".join(r[1][0] for r in a),
                 "paths_alone": "".join(r[1][0] for r in b),
                 "first_logit_diff_token": first_logit,
                 "first_token_diff": first_token,
                 "identical_tokens": first_token is None}
        if first_logit is not None:
            entry["at_first_diff"] = {
                "path_batch": a[first_logit][1],
                "path_alone": b[first_logit][1],
                "max_abs_logit_diff": diffs[first_logit],
                "max_abs_logit": a[first_logit][2].abs().max().item()}
            if first_parted is None:
                first_parted = (i, first_logit)
        report.append(entry)
        print("request " + json.dumps(entry))
    out = {"card": cs.card_line(), "requests": report}
    if first_parted is not None:
        i, t = first_parted
        _, _, _, fb, rb = batch[i][t]
        _, _, _, fa, ra = alone[i][t]

        def row_in(batch_row):
            def pick(b):
                # a mixed step's token: the request's last token there
                return int(b.logits_rows[batch_row]) if b is not None \
                    else batch_row
            return pick

        xb = layer_outputs(range(len(prompts)), fb, row_in(rb))
        xa = layer_outputs([i], fa, row_in(ra))
        per_layer = [(u - v).abs().max().item() for u, v in zip(xb, xa)]
        first_layer = next((j for j, d in enumerate(per_layer) if d > 0),
                           None)
        out["layers_at_first_diff"] = {
            "request": i, "token": t, "first_layer": first_layer,
            "max_abs_diff_by_layer": per_layer,
            "max_abs_hidden": [x.abs().max().item() for x in xb]}
        print("layers " + json.dumps(out["layers_at_first_diff"]))
    same = sum(e["identical_tokens"] for e in report)
    print(f"identical continuations: {same} of {len(report)}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
