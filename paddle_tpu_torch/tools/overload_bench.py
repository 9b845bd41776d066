"""overload_bench: the SLO-aware overload protection A/B of the port.

Counterpart of the JAX package's ``tools/overload_bench.py``, with the
same ``OVERLOAD={json}`` report.  Drives the port's continuous-batching
engine under a seeded saturating and bursty open-loop trace on a
deterministic logical clock (step k runs at ``now = k * dt``), once per
admission policy (``fifo``, ``slo_aware``), and reports per policy:

* **goodput**: requests and tokens within the declared SLO, per the
  SLO tracker (shed requests are out of the denominators);
* **shed rate and shed visibility**: every shed is a span (root
  ``status="shed"``) and a ``serving_rejects_total{reason="shed"}`` /
  ``serving_shed_total`` count, all agreeing with ``stats["shed"]``;
* **starvation**: every submitted request finishes, sheds or is
  rejected, and the engine drains inside the step bound;
* the **burn-rate trajectory**, sampled every step.

The serving chaos faults (``utils/chaos.py``) ride along via
``--chaos``; both policies replay the same schedule.  A second pass
replays the A/B on a shared-prefix trace with the prefix cache on, and
``--kv-dtype`` a third with quantized pools bought by the f32 pool's
byte budget.  Everything that decides scheduling is a pure function of
the seed, so the report is the same run to run on one device.

Usage (the engine runs on the card unless ``--device cpu``):

  python -m paddle_tpu_torch.tools.overload_bench [--requests 48]
      [--rate 100] [--seed 0] [--slo-ttft 0.5] [--dt 0.05]
      [--chaos "req_burst=8@10"] [--json] [--device cpu]
  python -m paddle_tpu_torch.tools.overload_bench --quick  # exit 1
      unless slo_aware goodput strictly beats fifo, both policies are
      starvation-free, and every shed is span and counter visible
"""
from __future__ import annotations

import argparse
import sys


def build_args():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--requests", type=int, default=48)
    ap.add_argument("--rate", type=float, default=100.0,
                    help="Poisson arrival rate in LOGICAL req/s — the "
                         "default saturates the default engine")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--num-pages", type=int, default=32)
    ap.add_argument("--page-size", type=int, default=4)
    ap.add_argument("--max-batch", type=int, default=4)
    ap.add_argument("--token-budget", type=int, default=64)
    ap.add_argument("--prompt-min", type=int, default=4)
    ap.add_argument("--prompt-max", type=int, default=10)
    ap.add_argument("--new-min", type=int, default=4)
    ap.add_argument("--new-max", type=int, default=8)
    ap.add_argument("--prefix-len", type=int, default=12,
                    help="shared-prefix tokens for the SECOND A/B pass "
                         "(run with the CoW prefix cache armed; 0 "
                         "skips the pass)")
    ap.add_argument("--prefix-share", type=float, default=0.8)
    ap.add_argument("--dt", type=float, default=0.05,
                    help="logical seconds per engine step")
    ap.add_argument("--slo-ttft", type=float, default=0.5,
                    help="TTFT target in LOGICAL seconds (0 = unset)")
    ap.add_argument("--slo-token", type=float, default=0.0,
                    help="per-token target in LOGICAL seconds (0 = unset)")
    ap.add_argument("--objective", type=float, default=0.9)
    ap.add_argument("--window", type=int, default=32)
    ap.add_argument("--chaos", default="req_burst=8@10;pool_spike=20@16:12",
                    help="serving-fault schedule replayed for BOTH "
                         "policies ('' = none)")
    ap.add_argument("--kv-dtype", default="",
                    choices=["", "bfloat16", "int8"],
                    help="arm the kv_quant A/B: replay the SAME trace + "
                         "chaos schedule per policy with the quantized "
                         "KV pool at the f32 pool's byte budget (2-4x "
                         "pages at fixed HBM) — shed rate and preemption "
                         "pressure must not regress and must improve in "
                         "aggregate ('' = off)")
    ap.add_argument("--max-steps", type=int, default=5000,
                    help="starvation bound on engine steps per policy")
    ap.add_argument("--policies", default="fifo,slo_aware")
    ap.add_argument("--json", action="store_true",
                    help="machine output only (the OVERLOAD= line)")
    ap.add_argument("--device", default="cuda",
                    help="the engine's device (cuda, or cpu)")
    ap.add_argument("--quick", action="store_true",
                    help="bounded tier-1 smoke mode")
    return ap


def drive(policy: str, args, cfg, trace, prefix_cache: bool = False,
          kv_dtype: str = "", kv_budget_mb: float = 0.0):
    """One policy's full run: fresh engine, fresh telemetry/tracing/
    chaos state, deterministic logical clock.  ``prefix_cache`` arms
    the CoW prefix cache (the shared-prefix A/B pass); ``kv_dtype`` +
    ``kv_budget_mb`` arm the quantized-pool pass (num_pages derived
    from the byte budget instead of --num-pages)."""
    import numpy as np

    from paddle_tpu_torch.inference.serving import Request, ServingEngine
    from paddle_tpu_torch.utils import chaos, telemetry, tracing
    from paddle_tpu_torch.utils.flags import set_flags

    set_flags({"FLAGS_trace_requests": 1, "FLAGS_chaos": args.chaos or ""})
    chaos.reset()          # fresh fault counters/spikes per policy
    tracing.reset()
    telemetry.registry().reset()
    telemetry.slo_tracker().configure(
        ttft_s=args.slo_ttft or None, token_s=args.slo_token or None,
        objective=args.objective, window=args.window)

    kv_kw = (dict(kv_dtype=kv_dtype, kv_budget_mb=kv_budget_mb)
             if kv_dtype else {})
    eng = ServingEngine(cfg, num_pages=args.num_pages,
                        page_size=args.page_size, max_batch=args.max_batch,
                        token_budget=args.token_budget,
                        prefill_bucket_min=4, seed=args.seed,
                        admission_policy=policy, device=args.device,
                        prefix_cache=prefix_cache, **kv_kw)
    pending = sorted(trace, key=lambda e: (e.arrival, e.req_id))
    burst_rng = np.random.RandomState(args.seed + 9173)
    reqs, rejected = {}, {}

    def _submit(req):
        reqs[req.req_id] = req
        try:
            eng.submit(req)
        except ValueError as e:
            rejected[req.req_id] = str(e)

    i = step = 0
    burn_traj = []
    while (i < len(pending) or eng.has_work()) and step < args.max_steps:
        step += 1
        now = step * args.dt
        while i < len(pending) and pending[i].arrival <= now:
            e = pending[i]
            i += 1
            _submit(Request(e.req_id, list(e.prompt), e.max_new_tokens,
                            e.arrival))
        eng.step(now)
        # chaos req_burst: the schedule queued N extra requests at this
        # engine step: seeded prompts, the same for both policies
        for _ in range(chaos.take_burst()):
            n = int(burst_rng.randint(args.prompt_min, args.prompt_max + 1))
            m = int(burst_rng.randint(args.new_min, args.new_max + 1))
            prompt = burst_rng.randint(
                0, cfg.vocab_size, size=n).astype(int).tolist()
            _submit(Request(f"burst-{len(reqs)}", prompt, m, now))
        burn_traj.append(round(telemetry.slo_tracker().burn_rate(), 6))

    drained = i >= len(pending) and not eng.has_work()
    outcomes = {}
    for rid, r in reqs.items():
        if rid in rejected:
            outcomes[rid] = "rejected"
        elif r.shed_at is not None:
            outcomes[rid] = "shed"
        elif r.finished_at is not None:
            outcomes[rid] = "finished"
        else:
            outcomes[rid] = "hung"
    counts = {o: sum(1 for v in outcomes.values() if v == o)
              for o in ("finished", "shed", "rejected", "hung")}
    starvation_free = drained and counts["hung"] == 0

    # shed visibility: every shed decision is a span AND a counter
    shed_ids = [rid for rid, o in outcomes.items() if o == "shed"]
    by_req = {t.req_id: t for t in tracing.store().traces()}
    spans_ok = all(
        rid in by_req and any(
            s.name == "request" and s.attrs.get("status") == "shed"
            for s in by_req[rid].spans)
        for rid in shed_ids)
    snap = telemetry.snapshot()

    def _reject_count(reason):
        for s in snap.get("serving_rejects_total", {"series": []})["series"]:
            if s["labels"].get("reason") == reason:
                return s["value"]
        return 0

    shed_total = (snap["serving_shed_total"]["series"][0]["value"]
                  if "serving_shed_total" in snap else 0)
    counters_ok = (_reject_count("shed") == shed_total
                   == len(shed_ids) == eng.stats["shed"])

    slo = telemetry.slo_tracker().report()
    stride = max(1, len(burn_traj) // 40)
    return {
        "policy": policy,
        "steps": step,
        "submitted": len(reqs),
        "outcomes": counts,
        "shed_rate": round(counts["shed"] / max(len(reqs), 1), 6),
        "goodput": slo["goodput"],
        "burn_rate_final": slo["burn_rate"],
        "burn_trajectory": burn_traj[::stride],
        "starvation_free": bool(starvation_free),
        "sheds_visible": bool(spans_ok and counters_ok),
        "preempted": eng.stats["preempted"],
        "scheduler": dict(eng.stats),
        "prefix_cache": eng.kv.stats()["prefix_cache"],
        "kv_pool": {"dtype": eng.kv_dtype,
                    "num_pages": eng.core.kv_config.num_pages},
    }


def run(argv=None):
    """Parse ``argv``, run every pass; ``(payload, ok)``."""
    args = build_args().parse_args(argv)
    if args.quick:
        args.requests = min(args.requests, 24)
        args.rate = 200.0
        args.layers = 1
        args.max_seq, args.num_pages = 64, 32
        args.new_max = min(args.new_max, 6)
        args.slo_ttft = args.slo_ttft or 0.3
        args.chaos = "req_burst=6@6;pool_spike=20@10:8"
        args.max_steps = min(args.max_steps, 2000)
        if not args.kv_dtype:
            args.kv_dtype = "int8"  # the quick kv-quant headroom oracle

    from paddle_tpu_torch.inference.serving import DecoderConfig
    from paddle_tpu_torch.utils.loadgen import poisson_trace

    cfg = DecoderConfig(vocab_size=args.vocab, hidden=args.hidden,
                        num_heads=args.heads, num_layers=args.layers,
                        max_seq_len=args.max_seq)
    trace = poisson_trace(
        args.requests, args.rate, cfg.vocab_size,
        prompt_len_range=(args.prompt_min, args.prompt_max),
        max_new_range=(args.new_min, args.new_max), seed=args.seed)

    policies = [p.strip() for p in args.policies.split(",") if p.strip()]

    def run_ab(ab_trace, prefix_cache, tag):
        results = {}
        for policy in policies:
            results[policy] = drive(policy, args, cfg, ab_trace,
                                    prefix_cache=prefix_cache)
            if not args.json:
                r = results[policy]
                print(f"[{tag}:{policy}] steps={r['steps']} "
                      f"outcomes={r['outcomes']} "
                      f"goodput={r['goodput']['requests_within_slo']}"
                      f"/{r['goodput']['requests_total']} requests "
                      f"({r['goodput']['request_goodput']:.3f}) "
                      f"shed_rate={r['shed_rate']:.3f} "
                      f"preempted={r['preempted']} "
                      f"starvation_free={r['starvation_free']} "
                      f"sheds_visible={r['sheds_visible']}")
        comparison = {}
        if "fifo" in results and "slo_aware" in results:
            f = results["fifo"]["goodput"]
            s = results["slo_aware"]["goodput"]
            comparison = {
                "fifo_requests_within_slo": f["requests_within_slo"],
                "slo_aware_requests_within_slo": s["requests_within_slo"],
                "fifo_request_goodput": f["request_goodput"],
                "slo_aware_request_goodput": s["request_goodput"],
                "slo_aware_strictly_better": bool(
                    s["request_goodput"] > f["request_goodput"]
                    and s["requests_within_slo"]
                    >= f["requests_within_slo"]),
                "fifo_never_sheds":
                    results["fifo"]["outcomes"]["shed"] == 0,
            }
        return results, comparison

    results, comparison = run_ab(trace, False, "plain")

    # the prefix pass: the SAME policy A/B on the seeded SHARED-PREFIX
    # trace with the CoW prefix cache armed; cheaper admission must not
    # invert the policy ordering (slo_aware still strictly beats fifo)
    prefix_section = None
    if args.prefix_len > 0:
        ptrace = poisson_trace(
            args.requests, args.rate, cfg.vocab_size,
            prompt_len_range=(args.prompt_min, args.prompt_max),
            max_new_range=(args.new_min, args.new_max), seed=args.seed,
            prefix_len=args.prefix_len, prefix_share=args.prefix_share)
        p_results, p_comparison = run_ab(ptrace, True, "prefix")
        prefix_section = {
            "prefix_len": args.prefix_len,
            "prefix_share": args.prefix_share,
            "policies": p_results,
            "comparison": p_comparison,
        }

    # the kv pass: the SAME trace + chaos schedule per policy with the
    # quantized KV pool at the f32 pool's BYTE budget — 2-4x pages at
    # fixed HBM.  The capacity must show up as overload headroom: per
    # policy, shed count and preemption count no worse than the f32
    # baseline, and in aggregate strictly fewer preemptions (the
    # pool_spike chaos seizes an absolute page count, so the bigger
    # pool keeps more sequences resident through the spike).
    kv_section = None
    if args.kv_dtype:
        head_dim = cfg.hidden // cfg.num_heads
        page_bytes_f32 = (2 * cfg.num_layers * cfg.num_heads
                          * args.page_size * head_dim * 4)
        budget_mb = args.num_pages * page_bytes_f32 / float(1 << 20)
        k_results = {}
        for policy in policies:
            k_results[policy] = drive(policy, args, cfg, trace,
                                      kv_dtype=args.kv_dtype,
                                      kv_budget_mb=budget_mb)
            if not args.json:
                r = k_results[policy]
                print(f"[kv:{policy}] pages={r['kv_pool']['num_pages']} "
                      f"outcomes={r['outcomes']} "
                      f"shed_rate={r['shed_rate']:.3f} "
                      f"preempted={r['preempted']} "
                      f"starvation_free={r['starvation_free']}")
        k_comparison = {}
        if all(p in results and p in k_results for p in policies):
            base_shed = sum(results[p]["outcomes"]["shed"]
                            for p in policies)
            base_pre = sum(results[p]["preempted"] for p in policies)
            kv_shed = sum(k_results[p]["outcomes"]["shed"]
                          for p in policies)
            kv_pre = sum(k_results[p]["preempted"] for p in policies)
            k_comparison = {
                "f32_shed_total": base_shed, "kv_shed_total": kv_shed,
                "f32_preempted_total": base_pre,
                "kv_preempted_total": kv_pre,
                "per_policy_no_worse": bool(all(
                    k_results[p]["outcomes"]["shed"]
                    <= results[p]["outcomes"]["shed"]
                    and k_results[p]["preempted"] <= results[p]["preempted"]
                    for p in policies)),
                "pressure_strictly_improved": bool(
                    kv_pre < base_pre
                    and kv_shed <= base_shed),
            }
        kv_section = {
            "kv_dtype": args.kv_dtype,
            "budget_mb": round(budget_mb, 6),
            "policies": k_results,
            "comparison": k_comparison,
        }

    payload = {
        "mode": "quick" if args.quick else "full",
        "device": args.device,
        "requests": args.requests, "rate_req_s": args.rate,
        "seed": args.seed, "dt": args.dt,
        "slo": {"ttft_s": args.slo_ttft or None,
                "token_s": args.slo_token or None,
                "objective": args.objective, "window": args.window},
        "chaos": args.chaos,
        "policies": results,
        "comparison": comparison,
        **({"prefix_trace": prefix_section} if prefix_section else {}),
        **({"kv_quant": kv_section} if kv_section else {}),
    }
    ok = all(r["starvation_free"] and r["sheds_visible"]
             for r in results.values())
    if comparison:
        ok = ok and comparison["slo_aware_strictly_better"] \
            and comparison["fifo_never_sheds"]
    if prefix_section:
        ok = ok and all(
            r["starvation_free"] and r["sheds_visible"]
            for r in prefix_section["policies"].values())
        if prefix_section["comparison"]:
            ok = ok and prefix_section["comparison"][
                "slo_aware_strictly_better"]
    if kv_section:
        ok = ok and all(
            r["starvation_free"] and r["sheds_visible"]
            for r in kv_section["policies"].values())
        if kv_section["comparison"]:
            ok = ok and kv_section["comparison"]["per_policy_no_worse"] \
                and kv_section["comparison"]["pressure_strictly_improved"]
    return payload, ok


def main(argv=None) -> int:
    from paddle_tpu_torch.utils.loadgen import emit_json

    payload, ok = run(argv)
    emit_json("OVERLOAD", payload)
    if payload["mode"] == "quick" and not ok:
        kv = payload.get("kv_quant")
        prefix = payload.get("prefix_trace")
        print("FAIL: overload oracle did not hold "
              f"(comparison={payload['comparison']}, prefix="
              f"{prefix and prefix['comparison']}, kv="
              f"{kv and kv['comparison']})", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
