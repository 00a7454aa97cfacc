"""Checkpointing of the port, in the reference's on-disk format, and
filter-layout migration (DESIGN.md §3.6), tenant hand-over (§4.6) and the
elastic sharded state's re-meshing (§4.4)."""

from .manager import CheckpointManager
from .migrate import (check_tenant_meta, export_tenant, import_tenant,
                      layout_meta, migrate_filter_state, migrate_sharded_state,
                      router_meta, tenant_meta)

__all__ = ["CheckpointManager", "layout_meta", "migrate_filter_state",
           "tenant_meta", "check_tenant_meta", "export_tenant",
           "import_tenant", "router_meta", "migrate_sharded_state"]
