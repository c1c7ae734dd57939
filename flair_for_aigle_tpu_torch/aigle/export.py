"""Detection export to the Aigle PostGIS schema + GPKG
(reference utils/export.py).

Records flow: class remap via Mapper (water->plan d'eau, -1 dropped),
per-class min-max confidence normalization, then export. With
``export_sql=True``:

* if a database is reachable (``db=`` argument or ``DB_STRING_PROD`` DSN
  with an importable driver — aigle/db.py), run the live transaction:
  batch row insert RETURNING id, then 50k-chunked detection inserts with
  SRID-prefixed WKT geometry, rolled back atomically on any failure
  (reference export.py:48-115);
* otherwise fall back to writing the same statements to a .sql file ready
  for psql.

A GPKG dump is always written (reference export.py:117-125).
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Any, Dict, List

from flair_for_aigle_tpu_torch.aigle.db import Database, DatabaseError, sql_quote
from flair_for_aigle_tpu_torch.geo.crs import transform_geometry
from flair_for_aigle_tpu_torch.geo.gpkg import write_gpkg

logger = logging.getLogger(__name__)


class Exporter:
    def __init__(self, detection_crs: str) -> None:
        self.export_batch_size = 50000
        self.db_string_aigle = os.getenv("DB_STRING_PROD")
        self.detection_crs = detection_crs

    def transform_to_inference_table(self, records: List[dict], batch_id: int
                                     ) -> List[dict]:
        srid = str(self.target_export_crs).replace("EPSG:", "")
        out = []
        for r in records:
            out.append({
                "score": r["confidence"],
                "object_type": r["class_id"],
                "geometry_ewkt": f"SRID={srid};{r['geometry'].wkt}",
                "geometry": r["geometry"],
                "batch_id": batch_id,
            })
        return out

    def _batch_insert_sql(self, export_context: Dict[str, Any],
                          id_expr: str = "nextval('detections.batch_id_seq'"
                                         "::regclass)") -> str:
        return (
            "INSERT INTO detections.batch (id, batch_name, created_at, "
            "model_id, batch_tiles_url, description) VALUES("
            f"{id_expr}, "
            f"'{sql_quote(export_context['batch_name'])}', "
            f"'{datetime.datetime.now()}', "
            f"{int(export_context['model_id'])}, '', "
            f"'{sql_quote(export_context['description'])}') RETURNING id;"
        )

    def _detection_insert_sql(self, rows: List[dict]) -> List[str]:
        stmts = []
        for i in range(0, len(rows), self.export_batch_size):
            chunk = rows[i:i + self.export_batch_size]
            values = ",\n".join(
                f"({r['batch_id']}, {r['score']}, "
                f"'{sql_quote(r['object_type'])}', "
                f"'{r['geometry_ewkt']}')"
                for r in chunk
            )
            stmts.append(
                "INSERT INTO detections.inference "
                "(batch_id, score, object_type, geometry) VALUES\n"
                f"{values};"
            )
        return stmts

    def insert_batch_object(self, db: Database,
                            export_context: Dict[str, Any]) -> int:
        """Create the detections.batch row, returning its id
        (reference export.py:48-58)."""
        sql = self._batch_insert_sql(
            export_context, id_expr=db.next_id_expr("detections.batch_id_seq")
        )
        batch_id = db.execute_returning_id(sql.rstrip(";"))
        logger.info("batch initialized in db - id : %s, name : %s",
                    batch_id, export_context["batch_name"])
        return batch_id

    def insert_batch_detections(self, db: Database, rows: List[dict],
                                chunk_size: int | None = None) -> None:
        """50k-chunked detection inserts (reference export.py:60-71)."""
        chunk_size = chunk_size or self.export_batch_size
        n_chunks = max(1, -(-len(rows) // chunk_size))
        for i in range(0, len(rows), chunk_size):
            logger.info("inserting inference batch %d/%d in db...",
                        i // chunk_size + 1, n_chunks)
            chunk = rows[i:i + chunk_size]
            values = ",\n".join(
                f"({r['batch_id']}, {r['score']}, "
                f"'{sql_quote(r['object_type'])}', '{r['geometry_ewkt']}')"
                for r in chunk
            )
            db.execute(
                "INSERT INTO detections.inference "
                f"(batch_id, score, object_type, geometry) VALUES\n{values}"
            )
        logger.info("batch detections inserted in db")

    def export_to_db(self, db: Database, work: List[dict],
                     export_context: Dict[str, Any]) -> int:
        """Atomic live export: batch row + detections in one transaction,
        rolled back on any failure (reference export.py:107-115)."""
        try:
            with db.transaction():
                batch_id = self.insert_batch_object(db, export_context)
                rows = self.transform_to_inference_table(work, batch_id)
                self.insert_batch_detections(db, rows)
            return batch_id
        except Exception as e:
            logger.error("Transaction failed: %s", e)
            raise

    def export_to_aigle(self, records: List[dict], target_export_crs: str,
                        output_folder: str, mapper, export_context: Dict,
                        db: Database | None = None) -> str:
        self.target_export_crs = target_export_crs
        os.makedirs(output_folder, exist_ok=True)

        # reproject + remap classes (reference export.py:92-100)
        work = []
        for r in records:
            geom = transform_geometry(r["geometry"], self.detection_crs,
                                      target_export_crs)
            cls = mapper.simplify_flair_classes_app(r["class_id"])
            if cls == -1:
                continue
            work.append({"geometry": geom,
                         "class_id": mapper.map_aigle_classes_labels(cls),
                         "confidence": float(r.get("confidence", 0.0))})

        # per-class min-max confidence normalization (export.py:103)
        by_cls: Dict[Any, list] = {}
        for r in work:
            by_cls.setdefault(r["class_id"], []).append(r)
        for rows in by_cls.values():
            vals = [r["confidence"] for r in rows]
            lo, hi = min(vals), max(vals)
            for r in rows:
                r["confidence"] = (
                    (r["confidence"] - lo) / (hi - lo) if hi > lo else 0.0
                )

        batch_id = -1
        if export_context.get("export_sql"):
            if db is None and self.db_string_aigle:
                try:
                    db = Database.connect(self.db_string_aigle)
                except DatabaseError as e:
                    logger.warning(
                        "DB unreachable (%s); falling back to .sql emission", e
                    )
            if db is not None:
                batch_id = self.export_to_db(db, work, export_context)
            else:
                rows = self.transform_to_inference_table(work, batch_id=0)
                sql_path = os.path.join(
                    output_folder,
                    f"batch_segmentations_{export_context['batch_name']}.sql",
                )
                with open(sql_path, "w") as f:
                    f.write("BEGIN;\n")
                    f.write(self._batch_insert_sql(export_context) + "\n")
                    for stmt in self._detection_insert_sql(rows):
                        f.write(stmt + "\n")
                    f.write("COMMIT;\n")
                logger.info("SQL export written to %s (apply with psql)",
                            sql_path)

        rows = self.transform_to_inference_table(work, batch_id=batch_id)
        gpkg_name = f"batch_segmentations_{export_context['batch_name']}.gpkg"
        exp_file = os.path.join(output_folder, gpkg_name)
        write_gpkg(
            exp_file,
            [{"geometry": r["geometry"], "score": r["score"],
              "object_type": r["object_type"], "batch_id": r["batch_id"]}
             for r in rows],
            layer="detections", crs=target_export_crs,
        )
        logger.info("batch segmentation saved to: %s", exp_file)
        return exp_file
