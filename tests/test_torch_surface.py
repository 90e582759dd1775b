"""The PyTorch port carries every public name of the JAX package.

For each module of `slam_sensor_fusion_tpu/`, every public top-level name
(a function, class or assignment; in a package's `__init__.py` also what it
re-exports) must be bound at the top level of the port's module of the same
path, unless it is on `NOT_CARRIED` below with the reason. Both packages
are read with `ast`; nothing is imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
JAX_PKG = ROOT / "slam_sensor_fusion_tpu"
PORT_PKG = ROOT / "slam_sensor_fusion_tpu_torch"

#: public JAX names the port does not carry, by module, each with its reason
NOT_CARRIED = {
    # the `jax.Array` type alias: the port's arrays are `torch.Tensor`
    "*": {"Array"},
    # the TPU v5e peaks: the port's roofline uses the H100's (H100_*)
    "utils/roofline.py": {"V5E_HBM_BYTES", "V5E_MXU_BF16_FLOPS", "V5E_VPU_F32_OPS_EST"},
}


def _public_names(path: pathlib.Path, with_imports: bool) -> set[str]:
    """The public names bound at the top level of a module (inside top-level
    `if` and `try` blocks too); imported names only `with_imports`."""
    found = set()

    def visit(body):
        for node in body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                found.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                found.update(n.id for tg in targets for n in ast.walk(tg) if isinstance(n, ast.Name))
            elif isinstance(node, (ast.Import, ast.ImportFrom)) and with_imports:
                found.update((a.asname or a.name).split(".")[0] for a in node.names)
            elif isinstance(node, (ast.If, ast.Try)):
                visit(node.body)
                visit(node.orelse)
                for handler in getattr(node, "handlers", []):
                    visit(handler.body)
                visit(getattr(node, "finalbody", []))

    visit(ast.parse(path.read_text()).body)
    return {n for n in found if not n.startswith("_")}


MODULES = sorted(str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py"))


@pytest.mark.parametrize("module", MODULES)
def test_port_module_has_every_public_name(module):
    jax_path, port_path = JAX_PKG / module, PORT_PKG / module
    assert port_path.exists(), f"the port has no {module}"
    wanted = _public_names(jax_path, with_imports=jax_path.name == "__init__.py")
    wanted -= NOT_CARRIED["*"] | NOT_CARRIED.get(module, set())
    missing = sorted(wanted - _public_names(port_path, with_imports=True))
    assert not missing, f"{module}: the port lacks {missing}"


def test_allow_list_names_exist():
    """Every entry of NOT_CARRIED is a public name of its JAX module."""
    for module, names in NOT_CARRIED.items():
        if module != "*":
            assert names <= _public_names(JAX_PKG / module, with_imports=False), module
