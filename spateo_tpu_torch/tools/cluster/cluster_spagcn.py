"""Reference-named module alias (reference tools/cluster/cluster_spagcn.py):
`spagcn_vanilla` lives in find_clusters.py here."""

from .find_clusters import spagcn_vanilla  # noqa: F401
