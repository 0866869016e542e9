"""Requirement control (parity: reference utils/req.py).

``find_imports`` AST-walks a source folder collecting imported top-level
modules; ``control_requirements`` maps them to installed distributions via
importlib.metadata and rewrites ``requirements.txt`` so workers can
reproduce the environment (reference utils/req.py:19-69, 101-134).
"""

import ast
import os
import sys
from importlib import metadata


def find_imports(folder: str):
    """Set of top-level module names imported by .py files under folder."""
    mods = set()
    for root, dirs, files in os.walk(folder):
        dirs[:] = [d for d in dirs if not d.startswith('.')
                   and d != '__pycache__']
        for f in files:
            if not f.endswith('.py'):
                continue
            path = os.path.join(root, f)
            try:
                with open(path, encoding='utf-8', errors='ignore') as fh:
                    tree = ast.parse(fh.read())
            except SyntaxError:
                continue
            for node in ast.walk(tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        mods.add(alias.name.split('.')[0])
                elif isinstance(node, ast.ImportFrom):
                    if node.module and node.level == 0:
                        mods.add(node.module.split('.')[0])
    return mods


def module_distributions(mods):
    """[(library, version)] for modules that map to installed dists."""
    pkg_map = metadata.packages_distributions()
    stdlib = set(sys.stdlib_module_names)
    out = {}
    for mod in sorted(mods):
        if mod in stdlib:
            continue
        for dist in pkg_map.get(mod, []):
            try:
                out[dist] = metadata.version(dist)
            except metadata.PackageNotFoundError:
                continue
    return sorted(out.items())


def control_requirements(folder: str, write_file: bool = True):
    """Scan imports and (optionally) rewrite requirements.txt
    (reference utils/req.py:101-134)."""
    libs = module_distributions(find_imports(folder))
    if write_file:
        path = os.path.join(folder, 'requirements.txt')
        with open(path, 'w') as fh:
            for lib, version in libs:
                fh.write(f'{lib}=={version}\n')
    return libs


__all__ = ['find_imports', 'module_distributions', 'control_requirements']
