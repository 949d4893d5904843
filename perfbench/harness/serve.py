"""A serving cell: set-up, the timed window of back-to-back
``Engine.serve`` calls, and the output check against the plain reference.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List

import numpy as np
import torch

from . import traffic as TR


@dataclasses.dataclass
class Call:
    """One ``Engine.serve`` call of the window."""
    t_start: float
    t_end: float
    requests: List[TR.ServeRequest]
    outputs: Dict[int, List[int]]


def engine_for(cfg, weights, mix: Dict, device, telemetry=None):
    from repro_torch.launch.serve import Engine
    return Engine(cfg, max_seq=int(mix["max_seq"]), n_slots=int(mix["slots"]),
                  params=weights, device=device, telemetry=telemetry,
                  kv_layout=mix["kv_layout"])


def _requests(reqs: List[TR.ServeRequest]):
    from repro_torch.runtime.scheduler import Request
    return [Request(r.uid, r.prompt.tolist(), r.max_new_tokens) for r in reqs]


def serve_call(engine, reqs: List[TR.ServeRequest]) -> Call:
    t0 = time.perf_counter()
    outputs, _ = engine.serve(_requests(reqs))
    t1 = time.perf_counter()
    return Call(t0, t1, reqs, {uid: list(v) for uid, v in outputs.items()})


def warm_up(engine, mix: Dict, vocab: int) -> None:
    """One call with a prompt in every prefill bucket the mix uses and
    more requests than slots, so every shape of the window has run: each
    prefill bucket, the slot insert and the decode step of all slots."""
    lengths = TR.warmup_prompt_lengths(mix)
    n = max(len(lengths), int(mix["slots"]) + 1)
    rng = np.random.default_rng(0)
    reqs = [TR.ServeRequest(-1 - i, rng.integers(0, vocab,
                                                 lengths[i % len(lengths)]),
                            3) for i in range(n)]
    serve_call(engine, reqs)


def run_window(engine, stream: TR.ServeStream, seconds: float,
               on_call=None) -> List[Call]:
    """Back-to-back calls, each the stream's next ``requests_per_call``
    requests, until one ends after ``seconds`` from the first's start."""
    calls: List[Call] = []
    t0 = time.perf_counter()
    for i, reqs in enumerate(stream.calls()):
        if calls and time.perf_counter() - t0 >= seconds:
            break
        if on_call is not None:
            on_call(i)
        calls.append(serve_call(engine, reqs))
    return calls


def window_numbers(calls: List[Call]) -> Dict:
    """``gen_tok_s`` over the whole window: every generated token over the
    time from the first call's start to the last call's end."""
    tokens = sum(len(v) for c in calls for v in c.outputs.values())
    window_s = calls[-1].t_end - calls[0].t_start
    return {"tokens": tokens, "window_s": window_s, "calls": len(calls),
            "gen_tok_s": tokens / window_s, "attempted": sum(
                len(c.requests) for c in calls),
            "failed": sum(1 for c in calls for r in c.requests
                          if len(c.outputs.get(r.uid, ())) !=
                          r.max_new_tokens)}


def finished(calls: List[Call]):
    """Every request the window finished, with its served tokens."""
    return [(r, c.outputs[r.uid]) for c in calls for r in c.requests
            if r.uid in c.outputs]


def check_sample(done, seed: int, n: int):
    """The finished requests the output check reads: the one with the most
    served tokens and ``n - 1`` others drawn from ``seed``, in the order
    they were served (all of them where ``n`` or fewer finished)."""
    if len(done) <= n:
        return list(done)
    longest = max(range(len(done)), key=lambda i: (len(done[i][1]), -i))
    rest = [i for i in range(len(done)) if i != longest]
    rng = np.random.default_rng([int(seed) & (2**64 - 1), 7])
    keep = {longest, *rng.choice(rest, size=n - 1, replace=False).tolist()}
    return [done[i] for i in sorted(keep)]


def _gaps(exact, tokens_of):
    """Per position: the reference's best logit less its logit of the
    token ``tokens_of`` gives, and whether they differ."""
    gaps, parted = [], 0
    for lg, toks in zip(exact, tokens_of):
        t = torch.as_tensor(toks, device=lg.device)
        gaps.append(lg.max(dim=-1).values - lg.gather(1, t[:, None])[:, 0])
        parted += int((lg.argmax(dim=-1) != t).sum())
    g = torch.cat(gaps)
    return {"mean_gap": float(g.mean()), "logit_gap": float(g.max()),
            "parted_share": parted / g.numel(), "tokens_checked":
            int(g.numel())}


def check_served(conf: Dict, weights, done, max_seq: int, ref, device,
                 with_pads: bool, control: bool = False) -> Dict:
    """Run the float32 reference once over each finished request's prompt
    with its served tokens (with the prompt's padding to its prefill
    bucket where ``with_pads``: a MoE groups the padded prompt for
    capacity).  The numbers of a served token: the gap by
    which its logit lies below the reference's best at its position;
    ``mean_gap`` is their mean and ``logit_gap`` the widest.  With
    ``control``, the same numbers for the tokens the reference puts first
    when computed with fp8 products (the step below the configuration's
    bfloat16), under ``control_*``, and ``gap_share``: ``mean_gap`` over
    ``control_mean_gap``, the program's loss against the reference as a
    share of the loss one step down in precision makes at the same
    positions (a measure that does not move with how close the seed's
    weights put the best logits)."""
    from reference.common import Prec, exact_f32, layout_request
    seqs = [layout_request(r.prompt, toks, max_seq, with_pads, device)
            for r, toks in done]
    with torch.no_grad(), exact_f32():
        exact = ref.served_logits(conf, weights, seqs, Prec("f32"))
        out = _gaps(exact, [toks for _, toks in done])
        top2 = torch.cat([lg.topk(2, dim=-1).values for lg in exact])
        out["median_top2_margin"] = float((top2[:, 0] - top2[:, 1]).median())
        out["distinct_tokens"] = len({t for _, toks in done for t in toks})
        out["requests_checked"] = len(done)
        if control:
            low = ref.served_logits(conf, weights, seqs, Prec("fp8"))
            picks = [lg.argmax(dim=-1) for lg in low]
            out.update({f"control_{k}": v for k, v in
                        _gaps(exact, picks).items()})
            out["gap_share"] = out["mean_gap"] / max(
                out["control_mean_gap"], 1e-12)
    return out


def active_schedule(calls: List[Call], spans: List[Dict]) -> List[Dict]:
    """Each decode step of the window with the requests it decoded and
    their positions, rebuilt from the spans (``prefill`` carries the uid,
    in admission order) and the requests' lengths: the engine admits FIFO
    and a request decodes in every step after its prefill until it has
    its ``max_new_tokens``."""
    lengths = {r.uid: (len(r.prompt), r.max_new_tokens)
               for c in calls for r in c.requests}
    steps: List[Dict] = []
    live: Dict[int, int] = {}      # uid -> tokens served so far
    for s in spans:
        if s["name"] == "prefill":
            uid = s["attrs"]["uid"]
            if uid not in lengths:
                continue
            live[uid] = 1
            if lengths[uid][1] <= 1:
                live.pop(uid)
        elif s["name"] == "decode.step":
            act = {uid: lengths[uid][0] + n - 1 for uid, n in live.items()}
            steps.append({"t_end": s["t_end"], "dur_s": s["dur_s"],
                          "in_slice": s.get("in_slice", False),
                          "active": act, "call": s.get("call")})
            for uid in list(live):
                live[uid] += 1
                if live[uid] >= lengths[uid][1]:
                    live.pop(uid)
    return steps
