"""Source-database migrations: the DDL event trigger installation.

Reference parity: `run_source_migrations` (crates/etl/src/pipeline.rs:153-164
+ postgres/migrations.rs:102-122) installing
`migrations/source/20260415100000_schema_change_messages.up.sql` — an
`etl` schema with catalog-snapshot functions and a
`supabase_etl_ddl_message_trigger` event trigger that emits one
`pg_logical_emit_message('supabase_etl_ddl', json)` per changed replicated
table on ALTER TABLE, so schema changes flow through the WAL in commit
order with the data they precede.

Behavior matched:
  - skippable via `PipelineConfig.run_source_migrations=False`;
  - skipped (not errored) on standbys — a read replica cannot run DDL,
    and the primary's migrations replicate down anyway;
  - idempotent: applied migration names are recorded in
    `etl.source_migrations` and re-runs are no-ops.

The JSON payload matches `codec/event.decode_schema_change`:
`{"table_id": oid, "dropped": bool, "schema": {"id", "schema", "name",
"columns": [{"name", "type_oid", "modifier", "nullable",
"primary_key_ordinal", "default_expression"}...]}}`.

Copy of the reference's `etl_tpu/postgres/migrations.py`.
"""

from __future__ import annotations

import logging

from .codec.event import DDL_MESSAGE_PREFIX  # noqa: F401 (re-export)
from .source import ReplicationSource

logger = logging.getLogger("etl_tpu_torch.migrations")

# One entry per migration, applied in order; names are recorded in
# etl.source_migrations for idempotency.
SOURCE_MIGRATIONS: list[tuple[str, str]] = [
    ("20260415100000_schema_change_messages", r"""
CREATE SCHEMA IF NOT EXISTS etl;

CREATE TABLE IF NOT EXISTS etl.source_migrations (
    name text PRIMARY KEY,
    applied_at timestamptz NOT NULL DEFAULT now()
);

-- Catalog snapshot of one table as the decoder's JSON schema shape.
CREATE OR REPLACE FUNCTION etl.describe_table_schema(rel oid)
RETURNS jsonb LANGUAGE sql STABLE AS $fn$
    SELECT jsonb_build_object(
        'id', c.oid::bigint,
        'schema', n.nspname,
        'name', c.relname,
        'columns', COALESCE((
            SELECT jsonb_agg(jsonb_build_object(
                'name', a.attname,
                'type_oid', a.atttypid::bigint,
                'modifier', a.atttypmod,
                'nullable', NOT a.attnotnull,
                'primary_key_ordinal', pk.ordinal,
                'default_expression', pg_get_expr(d.adbin, d.adrelid)
            ) ORDER BY a.attnum)
            FROM pg_attribute a
            LEFT JOIN pg_attrdef d
                ON d.adrelid = a.attrelid AND d.adnum = a.attnum
            LEFT JOIN LATERAL (
                SELECT array_position(i.indkey::int2[], a.attnum) AS ordinal
                FROM pg_index i
                WHERE i.indrelid = a.attrelid AND i.indisprimary
            ) pk ON true
            WHERE a.attrelid = c.oid AND a.attnum > 0 AND NOT a.attisdropped
        ), '[]'::jsonb)
    )
    FROM pg_class c
    JOIN pg_namespace n ON n.oid = c.relnamespace
    WHERE c.oid = rel
$fn$;

-- Event trigger: one logical message per ALTERed table that belongs to
-- any publication (replicated tables are the only consumers).
CREATE OR REPLACE FUNCTION etl.emit_schema_change_messages()
RETURNS event_trigger LANGUAGE plpgsql AS $fn$
DECLARE
    cmd record;
BEGIN
    FOR cmd IN SELECT * FROM pg_event_trigger_ddl_commands() LOOP
        IF cmd.object_type IN ('table', 'table column')
           AND EXISTS (SELECT 1 FROM pg_publication_rel pr
                       WHERE pr.prrelid = cmd.objid) THEN
            PERFORM pg_logical_emit_message(
                true, 'supabase_etl_ddl',
                jsonb_build_object(
                    'table_id', cmd.objid::bigint,
                    'dropped', false,
                    'schema', etl.describe_table_schema(cmd.objid)
                )::text);
        END IF;
    END LOOP;
END
$fn$;

CREATE OR REPLACE FUNCTION etl.emit_table_drop_messages()
RETURNS event_trigger LANGUAGE plpgsql AS $fn$
DECLARE
    obj record;
BEGIN
    FOR obj IN SELECT * FROM pg_event_trigger_dropped_objects() LOOP
        IF obj.object_type = 'table' THEN
            PERFORM pg_logical_emit_message(
                true, 'supabase_etl_ddl',
                jsonb_build_object(
                    'table_id', obj.objid::bigint,
                    'dropped', true)::text);
        END IF;
    END LOOP;
END
$fn$;

DO $do$
BEGIN
    IF NOT EXISTS (SELECT 1 FROM pg_event_trigger
                   WHERE evtname = 'supabase_etl_ddl_message_trigger') THEN
        CREATE EVENT TRIGGER supabase_etl_ddl_message_trigger
            ON ddl_command_end
            WHEN TAG IN ('ALTER TABLE')
            EXECUTE FUNCTION etl.emit_schema_change_messages();
    END IF;
    IF NOT EXISTS (SELECT 1 FROM pg_event_trigger
                   WHERE evtname = 'supabase_etl_ddl_drop_trigger') THEN
        CREATE EVENT TRIGGER supabase_etl_ddl_drop_trigger
            ON sql_drop
            WHEN TAG IN ('DROP TABLE')
            EXECUTE FUNCTION etl.emit_table_drop_messages();
    END IF;
END
$do$;
"""),
]


async def run_source_migrations(source: ReplicationSource) -> bool:
    """Install/refresh the source-side DDL trigger machinery. Returns True
    when migrations ran, False when skipped (standby). Mirrors
    pipeline.rs:153-164 + postgres/migrations.rs:102-122."""
    if await source.is_in_recovery():
        logger.info("source is a standby; skipping source migrations "
                    "(they replicate from the primary)")
        return False
    applied = set(await source.applied_source_migrations())
    for name, sql in SOURCE_MIGRATIONS:
        if name in applied:
            continue
        await source.apply_source_migration(name, sql)
        logger.info("applied source migration %s", name)
    return True
