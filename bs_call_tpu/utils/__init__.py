import os


def env_flag(name: str, default: bool = False) -> bool:
    """Boolean env var with conventional falsy spellings. Unset (or
    empty) -> `default`; "0"/"false"/"off"/"no" (any case) -> False;
    anything else -> True."""
    v = os.environ.get(name)
    if v is None or v == "":
        return default
    return v.strip().lower() not in ("0", "false", "off", "no")


# Persistent XLA compilation cache when JAX_COMPILATION_CACHE_DIR is unset:
# a fixed directory inside the checkout (the path is part of the cache
# key, so it must not move between runs; .gitignore lists it).
JAX_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))),
    ".cache", "jax",
)


def configure_jax():
    """Import jax set up for this package and return it: float64 on (the
    exact device tier runs the f64 model; set once, before anything is
    traced) and the persistent compilation cache in JAX_CACHE_DIR unless
    JAX_COMPILATION_CACHE_DIR already chose one."""
    import jax

    if not jax.config.jax_enable_x64:
        jax.config.update("jax_enable_x64", True)
    if not jax.config.jax_compilation_cache_dir:
        os.makedirs(JAX_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", JAX_CACHE_DIR)
    return jax


class NoGpuError(RuntimeError):
    """--device gpu on a machine where JAX sees no GPU."""


def gpu_device():
    """The first GPU that JAX sees. Raises NoGpuError when there is
    none."""
    jax = configure_jax()
    try:
        return jax.devices("gpu")[0]
    except RuntimeError as e:
        raise NoGpuError(f"no GPU visible to JAX ({e})") from e
