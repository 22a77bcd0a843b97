"""The reference's LM runs that ``tests/test_torch_mesh_lm.py`` holds the
port's meshed LM to, run as their own process beside the port's pool
(``python tests/_ref_lm_mesh_runs.py IN.npz OUT.npz``), since it forces 4
host devices before JAX is imported.

IN.npz holds per case tag ``{tag}/arch``, ``{tag}/tokens``, optionally
``{tag}/steps`` (the decode steps' tokens) and the parameter tree's leaves
under ``{tag}/p/`` and their "/"-joined paths.  A case with steps gives
its meshless prefill logits, then one decode step's per row of
``steps``, stacked; one without gives its loss, the nll and aux metrics
and the gradients over a (2, 2) ('data', 'model') mesh (a
``jax.sharding.Mesh``: one from ``jax.make_mesh`` fails in ``jnp.take``
of the sharded embedding).  The configs run without remat, which changes
no value."""
# repro-lint: disable-file=host-sync
import dataclasses
import os
import sys

# one thread a host device: the runs share the host with the port's ranks
os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                           "--xla_cpu_multi_thread_eigen=false")
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.distributed.sharding import make_rules  # noqa: E402
from repro.models import transformer as RT  # noqa: E402


def unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, leaf in flat.items():
        node = tree
        *heads, last = path.split("/")
        for h in heads:
            node = node.setdefault(h, {})
        node[last] = jnp.asarray(leaf)
    return tree


def flatten(tree, prefix="") -> dict:
    if not isinstance(tree, dict):
        return {prefix[1:]: np.asarray(tree)}
    out = {}
    for k, v in tree.items():
        out.update(flatten(v, f"{prefix}/{k}"))
    return out


def cases(src: str) -> dict:
    """{tag: (config, tokens, decode tokens or None, parameters)}."""
    with np.load(src) as z:
        tags = sorted({k.split("/")[0] for k in z.files})
        out = {}
        for t in tags:
            cfg = dataclasses.replace(get_config(str(z[f"{t}/arch"])).smoke,
                                      remat=False)
            pre = f"{t}/p/"
            params = unflatten({k[len(pre):]: z[k] for k in z.files
                                if k.startswith(pre)})
            steps = z[f"{t}/steps"] if f"{t}/steps" in z.files else None
            out[t] = (cfg, jnp.asarray(z[f"{t}/tokens"]), steps, params)
    return out


# LLVM's cheaper passes: each program runs once, so its compile is its time
FAST = {"xla_backend_optimization_level": 0,
        "xla_llvm_disable_expensive_passes": True}


def mesh_loss(cfg, tokens, params, rules) -> dict:
    (loss, m), grads = jax.jit(jax.value_and_grad(
        lambda p, t: RT.loss_fn(cfg, p, {"tokens": t}, rules),
        has_aux=True), compiler_options=FAST)(params, tokens)
    out = {"loss": loss, "nll": m["loss"], "aux": m["aux"]}
    out.update({f"g/{k}": v for k, v in flatten(grads).items()})
    return out


def serve(cfg, tokens, steps, params) -> dict:
    logits, cache = jax.jit(lambda p, t: RT.prefill(cfg, p, t),
                            compiler_options=FAST)(params, tokens)
    grow = tokens.shape[1] + len(steps)
    cache = {k: (v if k == "len" else jnp.pad(
        v, [(0, 0)] * 3 + [(0, grow - v.shape[3])]
        + [(0, 0)] * (v.ndim - 4))) for k, v in cache.items()}
    dec = jax.jit(lambda p, c, t: RT.decode_step(cfg, p, c, t),
                  compiler_options=FAST)
    got = [np.asarray(logits)]
    for t in steps:
        logits, cache = dec(params, cache, jnp.asarray(t))
        got.append(np.asarray(logits))
    return {"logits": np.stack(got)}


def main(src: str, dst: str) -> None:
    mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                             ("data", "model"))
    rules = make_rules(mesh)
    out = {}
    for tag, (cfg, tokens, steps, params) in cases(src).items():
        got = (mesh_loss(cfg, tokens, params, rules) if steps is None
               else serve(cfg, tokens, steps, params))
        out.update({f"{tag}/{k}": np.asarray(v) for k, v in got.items()})
    np.savez(dst, **out)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
