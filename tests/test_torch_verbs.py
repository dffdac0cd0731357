"""Every verb of the JAX package's CLI has its counterpart in the port's:
an AST scan of ``add_parser`` calls in ``gravity_tpu/cli.py`` against the
port's parser, each verb's ``--help`` answering, and no refusal left that
cites the last item of ROADMAP.md's Queue 1."""

import ast
import contextlib
import io
import os
import pathlib

import pytest

from conftest import REPO_ROOT

from gravity_tpu_torch.cli import main as cli_main


def parser_verbs(path):
    """The first-argument string of every ``*.add_parser(...)`` call."""
    tree = ast.parse(pathlib.Path(path).read_text())
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "add_parser" and node.args
            and isinstance(node.args[0], ast.Constant)}


JAX_VERBS = sorted(parser_verbs(os.path.join(REPO_ROOT, "gravity_tpu",
                                             "cli.py")))


def test_the_port_has_every_verb_of_the_jax_cli():
    port = parser_verbs(os.path.join(REPO_ROOT, "gravity_tpu_torch",
                                     "cli.py"))
    assert len(JAX_VERBS) == 19
    assert set(JAX_VERBS) - port == set()


@pytest.mark.parametrize("verb", JAX_VERBS)
def test_each_verb_answers_help(verb):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(SystemExit) as e:
        cli_main([verb, "--help"])
    assert e.value.code == 0
    assert "usage:" in out.getvalue()


def test_no_refusal_cites_the_tooling_item():
    """Queue 1 item 10 is closed: no module, help text or refusal of the
    port points at it."""
    root = pathlib.Path(REPO_ROOT, "gravity_tpu_torch")
    hits = [str(p) for p in root.rglob("*.py")
            if "Queue 1 item 10" in p.read_text()]
    assert hits == []
