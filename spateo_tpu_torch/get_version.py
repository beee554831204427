"""Version helper (counterpart of `spateo_tpu.get_version`; reference
spateo/get_version.py, a vendored copy of flying-sheep/get_version).
Resolution order: git describe on the source tree, then the installed
distribution metadata, then the static fallback. Host code, copied; the
dependency table names torch where the JAX package's names JAX."""

from __future__ import annotations

import os
import re
from pathlib import Path
from subprocess import PIPE, CalledProcessError, run
from typing import List, NamedTuple, Optional, Union

__version__ = "0.1.0"

RE_GIT_DESCRIBE = r"v?(?:([\d.]+)(?:-(\d+)-g([0-9a-f]{7,}))?|([0-9a-f]{7,}))(-dirty)?$"
RE_VERSION = r"([\d.]+?)(?:\.dev(\d+))?(?:[_+-]([0-9a-zA-Z.]+))?"


def match_groups(regex: str, target: str):
    """Match or raise with the offending pattern (parity: reference
    get_version.py:18)."""
    match = re.match(regex, target)
    if match is None:
        raise re.error(f"Regex does not match '{target}'. RE Pattern: {regex}", regex)
    return match.groups()


class Version(NamedTuple):
    """Parsed (release, dev, labels) version triple (parity: reference
    get_version.py:25)."""

    release: str
    dev: Optional[str]
    labels: List[str]

    @staticmethod
    def parse(ver: str) -> "Version":
        release, dev, labels = match_groups(f"{RE_VERSION}$", ver)
        return Version(release, dev, labels.split(".") if labels else [])

    def __str__(self) -> str:
        release = self.release if self.release else "0.0"
        dev = f".dev{self.dev}" if self.dev else ""
        labels = f'+{".".join(self.labels)}' if self.labels else ""
        return f"{release}{dev}{labels}"


def get_version_from_dirname(name: str, parent: Path) -> Optional["Version"]:
    """Version from an extracted sdist directory name (parity: reference
    get_version.py:42)."""
    parent = parent.resolve()
    re_dirname = re.compile(f"{name}-{RE_VERSION}$")
    if not re_dirname.match(parent.name):
        return None
    return Version.parse(parent.name[len(name) + 1 :])


def get_version_from_git(parent: Path) -> Optional[str]:
    try:
        p = run(
            ["git", "describe", "--tags", "--dirty", "--always"],
            cwd=str(parent),
            stdout=PIPE,
            stderr=PIPE,
            encoding="utf-8",
            check=True,
        )
    except (OSError, CalledProcessError):
        return None
    # forms: "v1.2.3", "v1.2.3-5-gabcdef1", "abcdef1", each with
    # optional "-dirty"
    match = re.match(RE_GIT_DESCRIBE, p.stdout.strip())
    if not match:
        return None
    release, dev, hex_, bare_hex, dirty = match.groups()
    version = release or "0.1.0"
    if dev and dev != "0":
        version += f".dev{dev}+{hex_}"
    if dirty:
        version += ".dirty" if dev and dev != "0" else "+dirty"
    return version


def get_version_from_metadata(name: str) -> Optional[str]:
    try:
        from importlib.metadata import PackageNotFoundError, version
    except ImportError:
        return None
    try:
        return version(name)
    except PackageNotFoundError:
        return None


def get_version(package: Union[Path, str]) -> str:
    """Version of the package owning `package` (a module `__file__`)."""
    path = Path(package)
    name = path.parent.name if path.name.startswith("__init__") else path.stem
    if os.environ.get("READTHEDOCS") != "True":
        v = get_version_from_git(path.parent)
        if v:
            return v
    return get_version_from_metadata(name) or __version__


# scientific-stack packages whose versions matter for reproducing results —
# the role the reference's dynamo-release dependency list plays there
_CORE_DEPENDENCIES = (
    "torch",
    "numpy",
    "scipy",
    "pandas",
    "matplotlib",
    "h5py",
)


def get_all_dependencies_version(display: bool = True):
    """Table of installed versions of this framework's core dependencies
    (parity: reference get_version.py:165 `get_all_dependencies_version`,
    which walks the dynamo-release requirement set via pkg_resources;
    importlib.metadata replaces the deprecated pkg_resources here, and the
    IPython display degrades to a plain print outside notebooks)."""
    from importlib.metadata import PackageNotFoundError, version

    import pandas as pd

    rows = [["spateo-tpu-torch", get_version(__file__)]]
    for name in _CORE_DEPENDENCIES:
        try:
            rows.append([name, version(name)])
        except PackageNotFoundError:
            continue
    df = pd.DataFrame(rows, columns=["package", "version"]).set_index("package").T
    if display:
        try:
            from IPython.display import display as ipy_display

            pd.options.display.max_columns = None
            ipy_display(df)
        except ImportError:
            print(df.to_string())
        return None
    return df
