"""Process-environment helpers: shared-secret auth for the TCP services,
and the three decisions every accelerator entry point shares -- which
backend may run it (``require_accelerator``), where compiled programs are
cached (``enable_compile_cache``) and how much device memory one fused
search matrix may take (``fusion_budget_bytes``). Import-safe before jax
initializes: jax is imported only inside the functions that need it."""

from __future__ import annotations

import os
import sys

# Share of the device memory still free that the fused signature matrices
# (and their per-call query temporaries) may take. The rest stays free
# for the kernels' own working sets: the per-k-mer match words of one
# query batch are [nq, nk, W] uint32, as large as the matrix's row width
# times the batch's k-mer count.
DEVICE_BUDGET_FRACTION = 0.5
# The CPU backend reports no memory statistics. It runs the tests and
# small rehearsals, whose corpora are a few MiB, so a fixed budget stands
# in for the device's; KWAGE_FUSION_BUDGET_BYTES overrides both.
CPU_BUDGET_BYTES = 1 << 30

# <checkout>/.jax_cache: one fixed path, so that every process of every
# run finds what an earlier one compiled (the path is part of the key).
COMPILE_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def resolve_secret(secret: str | None) -> str:
    """An explicit secret wins; otherwise the KWAGE_QUEUE_SECRET env var;
    empty string = auth disabled."""
    if secret is not None:
        return secret
    return os.environ.get("KWAGE_QUEUE_SECRET", "")


def check_token(msg: dict, secret: str) -> bool:
    """Pop the "token" field from a wire message and verify it against
    the shared secret (constant-time). True when auth is disabled or the
    token matches."""
    import hmac

    token = str(msg.pop("token", ""))
    if not secret:
        return True
    return hmac.compare_digest(token, secret)


class NoAcceleratorError(RuntimeError):
    """An accelerator path was asked for, and JAX came up on the CPU
    without being told to."""


def require_accelerator(what: str) -> None:
    """Refuse to run ``what`` on a CPU backend that JAX fell back to.

    JAX quietly falls back to the CPU when it finds no accelerator; an
    accelerator flag would then run, slowly, on the host and report
    nothing of it. A CPU backend named on purpose (JAX_PLATFORMS=cpu, or
    jax.config's jax_platforms) is accepted: that is how the tests and
    the CPU rehearsals run the device paths."""
    import jax

    if jax.default_backend() != "cpu":
        return
    named = (jax.config.jax_platforms or "").lower().split(",")
    if "cpu" in named:
        return
    raise NoAcceleratorError(
        f"{what} needs an accelerator, but JAX found none and fell back to "
        "the CPU; set JAX_PLATFORMS=cpu to run it on the CPU on purpose"
    )


def accelerator_ready(flag: str) -> bool:
    """For a CLI flag that needs an accelerator: on a CPU that JAX fell
    back to, print why to stderr and return False; otherwise point the
    compile cache at its path and return True."""
    try:
        require_accelerator(flag)
    except NoAcceleratorError as e:
        print(e, file=sys.stderr)
        return False
    enable_compile_cache()
    return True


def enable_compile_cache() -> None:
    """Keep JAX's persistent compilation cache at one fixed path.

    Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
    sets nothing. Otherwise the cache lives in ``COMPILE_CACHE_DIR``
    inside the checkout. Call before the first compilation: a program
    compiled earlier in the process is not written to the cache."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", COMPILE_CACHE_DIR)


def fusion_budget_bytes(device=None) -> int:
    """Bytes of one device's memory that fused search matrices may take.

    KWAGE_FUSION_BUDGET_BYTES, when set, wins (tests shrink it to force
    the multi-chunk paths). Otherwise ``DEVICE_BUDGET_FRACTION`` of what
    the device has free now: its ``bytes_limit`` less ``bytes_in_use``.
    The CPU backend, which keeps no statistics, gets
    ``CPU_BUDGET_BYTES``; an accelerator that reports no ``bytes_limit``
    is an error, because no size could be derived for it."""
    env = os.environ.get("KWAGE_FUSION_BUDGET_BYTES")
    if env:
        return int(env)
    if device is None:
        import jax

        device = jax.local_devices()[0]
    stats = device.memory_stats() or {}
    if "bytes_limit" not in stats:
        if device.platform == "cpu":
            return CPU_BUDGET_BYTES
        raise RuntimeError(
            f"{device.platform} device {device.device_kind!r} reports no "
            "bytes_limit; set KWAGE_FUSION_BUDGET_BYTES"
        )
    free = int(stats["bytes_limit"]) - int(stats.get("bytes_in_use", 0))
    return max(int(free * DEVICE_BUDGET_FRACTION), 1)
