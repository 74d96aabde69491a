"""Shared CLI helpers for the harness tools (parity with
examples/helpers/cli_filters.h:68-186: the ``-l`` registry listing and
the -c/-d/-s filter conventions)."""

import sys


def apply_platform(argv=None):
    """Honour ``--cpu`` before any JAX backend initialises (stripping it
    from argv so per-tool parsers need not know about it), and keep the
    compile cache where utils.compile_cache says.  Lets every harness
    executable run on the host CPU when no GPU is attached."""
    import jax

    from viterbidecodercpp_jax.utils import compile_cache

    argv = sys.argv if argv is None else argv
    if "--cpu" in argv:
        argv.remove("--cpu")
        jax.config.update("jax_platforms", "cpu")
    compile_cache.enable()


def print_code_list(file=None):
    """Print the common-code registry like cli_print_codes
    (cli_filters.h:68-86): ID | name | K R | coefficients."""
    import viterbidecodercpp_jax as vt

    file = file or sys.stderr
    width = max(len(c.name) for c in vt.COMMON_CODES)
    print(f"ID | {'Name':>{width}} |  K  R | Coefficients", file=file)
    for i, code in enumerate(vt.COMMON_CODES):
        coeffs = ",".join(str(g) for g in code.G)
        print(f"{i:2d} | {code.name:>{width}} | {code.K:2d} {code.R:2d} | "
              f"[{coeffs}]", file=file)


def add_list_flag(ap):
    ap.add_argument("-l", action="store_true",
                    help="list the common-code registry and exit")


def handle_list_flag(args) -> bool:
    """Returns True (after printing) when -l was given; callers exit 0."""
    if getattr(args, "l", False):
        print_code_list()
        return True
    return False
