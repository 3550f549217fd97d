"""Nothing the benchmark runs imports JAX or the JAX package, and the
reference imports nothing of the program either.  Modules are compared
by their whole top-level name: the port's name begins with the JAX
package's."""

import ast
import os
import subprocess
import sys

import tiny

JAX = {"jax", "jaxlib", "flax", "sepi_tpu"}
PROGRAM = "sepi_tpu_torch"


def top_level_imports(path):
    tree = ast.parse(open(path).read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def files(sub):
    root = os.path.join(tiny.BENCH, sub)
    return [os.path.join(root, f) for f in sorted(os.listdir(root)) if f.endswith(".py")]


def test_the_whole_name_is_compared():
    import run

    assert run.forbidden_modules(["sepi_tpu_torch", "sepi_tpu_torch.ops", "numpy"]) == []
    assert run.forbidden_modules(["sepi_tpu.ops.features", "jaxlib.xla_client"]) == \
        ["jaxlib", "sepi_tpu"]


def test_the_reference_imports_neither_jax_nor_the_program():
    for path in files("reference"):
        names = top_level_imports(path)
        assert not names & (JAX | {PROGRAM}), (path, names)


def test_the_harness_imports_no_jax():
    for sub in ("", "harness", "drivers", "metrics", "tools", "models"):
        for path in files(sub):
            assert not top_level_imports(path) & JAX, path


def _modules_after(code):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([tiny.REPO, tiny.BENCH]))
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted("
                          "{m.split('.')[0] for m in sys.modules})))"],
                         cwd=tiny.REPO, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_loaded_modules_of_the_reference():
    loaded = _modules_after("import reference.frontend, reference.tdnn, reference.extract, "
                            "reference.backend, reference.train, reference.precision")
    assert not loaded & (JAX | {PROGRAM})


def test_the_model_kinds_reference_loads_neither_jax_nor_the_program():
    """A model kind's file builds the program inside a function; its
    reference, names and counts load none of it."""
    loaded = _modules_after(
        "import torch, tests.tiny as t\nfrom harness import core\n"
        "for cfg in (t.XVEC, t.CVEC):\n"
        "    name = 'xvector_v2' if cfg is t.XVEC else 'cvector_v5'\n"
        "    c = core.merge(core.load_json(core.BENCH_DIR / 'configs' / f'{name}.json'), cfg)\n"
        "    k = core.model_kind(c)\n"
        "    p = {n: torch.full(s, 0.1) for n, s in k.param_names(c).items()}\n"
        "    k.embed(torch.ones(60, 23), p, c, 'ref')\n"
        "    k.forward_train(torch.ones(2, 60, 23), p, c, 'xvec', 'bf16')\n"
        "    k.embed_flops(c, 60), k.train_forward_flops(c, 'xvec', 2, 60)")
    assert not loaded & (JAX | {PROGRAM})


def test_loaded_modules_of_a_run():
    loaded = _modules_after("import tests.tiny as t\nfor c in t.OVERRIDES: assert t.run(c)[0] == 0")
    assert not loaded & JAX and PROGRAM in loaded
