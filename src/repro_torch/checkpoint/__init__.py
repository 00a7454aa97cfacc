"""Checkpointing of the port, in the reference's on-disk format, and
filter-layout migration (DESIGN.md §3.6) and tenant hand-over (§4.6). The
reference's elastic-shard re-meshing (``router_meta``,
``migrate_sharded_state``) waits for the port of the sharded path (ROADMAP
[11])."""

from .manager import CheckpointManager
from .migrate import (check_tenant_meta, export_tenant, import_tenant,
                      layout_meta, migrate_filter_state, tenant_meta)

__all__ = ["CheckpointManager", "layout_meta", "migrate_filter_state",
           "tenant_meta", "check_tenant_meta", "export_tenant",
           "import_tenant"]
