"""The port's Aigle modules and driver, on the CPU.

* Its copies of ``aigle/pgwire.py``, ``aigle/db.py`` and ``aigle/export.py``
  against the in-process fake PostgreSQL server of ``tests/test_pgwire.py``
  (SCRAM-SHA-256, type decoding, the live-export transaction and its
  rollback, the model registry and geozone queries) and against the
  sqlite stand-in of ``tests/test_aigle_db.py``: the same cases, with the
  fixtures copied here.
* ``run_fast_aigle_segmentation`` of the port (``device="cpu"``) against
  the JAX package's on the same inputs: swin_micro-upernet, two 96 x 96
  rasters at 0.5 m/px, 64 px tiles with an 8 px margin, weights from one
  JAX init whose head bias favours class 6 (``tests/test_aigle.py``'s
  recipe), ``random.seed(0)`` before each run. The label rasters are
  byte-identical (the biased head leaves no near-tie; the zonal slice's
  rule, ``tests/test_torch_zonal_slice.py``, allows differences only at
  top-2 gaps below 1e-4); the per-raster ``.gpkg`` files hold the same
  records; the batch GPKG the same records in the same order, each
  EPSG:4326 coordinate within 1e-9; the ``.sql`` files are equal line by
  line with the batch's ``created_at`` timestamp masked (the one field
  that depends on the time of the run). A rerun of the port's driver
  skips both rasters, and ``python -m flair_for_aigle_tpu_torch.main
  --config <json> --device cpu`` drives the same run.
"""

import base64
import hashlib
import hmac
import json
import os
import random
import re
import shutil
import socket
import struct
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import yaml

from flair_for_aigle_tpu_torch.aigle.config import ArgsObject
from flair_for_aigle_tpu_torch.aigle.db import (
    Database,
    DatabaseError,
    _parse_pg_dsn,
    fetch_geozones,
    lookup_model_row,
    sql_quote,
)
from flair_for_aigle_tpu_torch.aigle.export import Exporter
from flair_for_aigle_tpu_torch.aigle.map import Mapper
from flair_for_aigle_tpu_torch.aigle.pgwire import DatabaseError as WireError
from flair_for_aigle_tpu_torch.aigle.pgwire import connect
from flair_for_aigle_tpu_torch.geo import geos
from flair_for_aigle_tpu_torch.geo.geos import box as geos_box

REPO = Path(__file__).resolve().parents[1]

# --- the fake server of tests/test_pgwire.py --------------------------------

USER, PASSWORD = "aigle", "s3cret#quote'"


def _msg(tag: bytes, payload: bytes = b"") -> bytes:
    return tag + struct.pack("!I", len(payload) + 4) + payload


def _row_desc(*cols):
    body = struct.pack("!H", len(cols))
    for name, typ in cols:
        body += name.encode() + b"\x00"
        body += struct.pack("!IHIhiH", 0, 0, typ, -1, -1, 0)
    return _msg(b"T", body)


def _data_row(*vals):
    body = struct.pack("!H", len(vals))
    for v in vals:
        if v is None:
            body += struct.pack("!i", -1)
        else:
            enc = str(v).encode()
            body += struct.pack("!i", len(enc)) + enc
    return _msg(b"D", body)


def _complete(status: str) -> bytes:
    return _msg(b"C", status.encode() + b"\x00")


def _ready(state: bytes = b"I") -> bytes:
    return _msg(b"Z", state)


def _error(message: str) -> bytes:
    fields = b"SERROR\x00C42601\x00M" + message.encode() + b"\x00\x00"
    return _msg(b"E", fields)


class FakePG(threading.Thread):
    """Single-connection protocol-v3 server with SCRAM-SHA-256 auth and a
    scriptable query handler. Records every received query."""

    def __init__(self, handler=None, auth: str = "scram"):
        super().__init__(daemon=True)
        self.queries: list[str] = []
        self.handler = handler or (lambda sql: [_complete("SELECT 0")])
        self.auth = auth
        self._lsock = socket.socket()
        self._lsock.bind(("127.0.0.1", 0))
        self._lsock.listen(1)
        self.port = self._lsock.getsockname()[1]
        self.error: Exception | None = None

    # --- framing ----------------------------------------------------------
    def _recv_exact(self, n):
        while len(self._rbuf) < n:
            chunk = self._c.recv(65536)
            if not chunk:
                raise ConnectionError("client closed")
            self._rbuf += chunk
        out, self._rbuf = self._rbuf[:n], self._rbuf[n:]
        return out

    def _read_startup(self):
        (length,) = struct.unpack("!I", self._recv_exact(4))
        return self._recv_exact(length - 4)

    def _read_msg(self):
        head = self._recv_exact(5)
        (length,) = struct.unpack("!I", head[1:5])
        return head[:1], self._recv_exact(length - 4)

    # --- auth -------------------------------------------------------------
    def _scram_exchange(self):
        self._c.sendall(_msg(b"R", struct.pack("!I", 10)
                             + b"SCRAM-SHA-256\x00\x00"))
        tag, body = self._read_msg()
        assert tag == b"p"
        end = body.index(b"\x00")
        assert body[:end] == b"SCRAM-SHA-256"
        (ln,) = struct.unpack("!I", body[end + 1:end + 5])
        client_first = body[end + 5:end + 5 + ln].decode()
        assert client_first.startswith("n,,")
        first_bare = client_first[3:]
        cnonce = dict(kv.split("=", 1)
                      for kv in first_bare.split(","))["r"]
        snonce = cnonce + base64.b64encode(os.urandom(9)).decode()
        salt = os.urandom(16)
        iters = 4096
        server_first = (f"r={snonce},s={base64.b64encode(salt).decode()},"
                        f"i={iters}")
        self._c.sendall(_msg(b"R", struct.pack("!I", 11)
                             + server_first.encode()))
        tag, body = self._read_msg()
        assert tag == b"p"
        client_final = body.decode()
        m = re.fullmatch(r"(c=biws,r=([^,]+)),p=(.+)", client_final)
        assert m and m.group(2) == snonce
        salted = hashlib.pbkdf2_hmac("sha256", PASSWORD.encode(), salt, iters)
        client_key = hmac.digest(salted, b"Client Key", "sha256")
        stored_key = hashlib.sha256(client_key).digest()
        auth_msg = ",".join([first_bare, server_first, m.group(1)])
        want_sig = hmac.digest(stored_key, auth_msg.encode(), "sha256")
        proof = base64.b64decode(m.group(3))
        recovered = bytes(a ^ b for a, b in zip(proof, want_sig))
        assert hashlib.sha256(recovered).digest() == stored_key, \
            "client proof rejected"
        server_key = hmac.digest(salted, b"Server Key", "sha256")
        v = base64.b64encode(
            hmac.digest(server_key, auth_msg.encode(), "sha256")).decode()
        self._c.sendall(_msg(b"R", struct.pack("!I", 12)
                             + f"v={v}".encode()))
        self._c.sendall(_msg(b"R", struct.pack("!I", 0)))

    def run(self):
        try:
            self._c, _ = self._lsock.accept()
            self._rbuf = b""
            startup = self._read_startup()
            assert b"user\x00" + USER.encode() in startup
            if self.auth == "scram":
                self._scram_exchange()
            else:
                self._c.sendall(_msg(b"R", struct.pack("!I", 0)))
            self._c.sendall(
                _msg(b"S", b"server_version\x0016.0\x00") + _ready()
            )
            in_tx = False
            while True:
                tag, body = self._read_msg()
                if tag == b"X":
                    break
                if tag != b"Q":
                    continue
                sql = body.rstrip(b"\x00").decode()
                self.queries.append(sql)
                up = sql.strip().upper()
                if up.startswith("BEGIN") or up.startswith("START"):
                    in_tx = True
                    self._c.sendall(_complete("BEGIN") + _ready(b"T"))
                    continue
                if up.startswith(("COMMIT", "ROLLBACK")):
                    in_tx = False
                    self._c.sendall(_complete(up.split()[0]) + _ready())
                    continue
                out = b"".join(self.handler(sql))
                self._c.sendall(out + _ready(b"T" if in_tx else b"I"))
            self._c.close()
        except Exception as e:  # surfaced by the test
            self.error = e
            try:
                self._c.close()  # unblock the client immediately
            except Exception:
                pass
        finally:
            self._lsock.close()


def _wire_db(srv):
    return Database.connect(f"postgresql://{USER}:{PASSWORD.replace('/', '')}@127.0.0.1:"
                            f"{srv.port}/aigle")


def test_pgwire_scram_auth_and_type_decoding():
    def handler(sql):
        return [_row_desc(("n", 23), ("x", 701), ("ok", 16), ("s", 25), ("none", 23)),
                _data_row(7, "1.5", "t", "text", None), _complete("SELECT 1")]

    srv = FakePG(handler)
    srv.start()
    conn = connect(user=USER, host="127.0.0.1", port=srv.port, database="aigle",
                   password=PASSWORD)
    cur = conn.cursor()
    cur.execute("select 1")
    assert cur.fetchall() == [(7, 1.5, True, "text", None)]
    conn.close()
    srv.join(timeout=10)
    assert srv.error is None


def test_pgwire_bad_password_rejected():
    srv = FakePG(auth="scram")
    srv.start()
    with pytest.raises((WireError, ConnectionError, OSError)):
        connect(user=USER, host="127.0.0.1", port=srv.port, password="wrong")
    srv.join(timeout=10)
    assert srv.error is not None


def test_pgwire_live_export_transaction_reference_sql():
    def handler(sql):
        if "RETURNING id" in sql:
            return [_row_desc(("id", 23)), _data_row(42), _complete("INSERT 0 1")]
        return [_complete("INSERT 0 2")]

    srv = FakePG(handler)
    srv.start()
    db = _wire_db(srv)
    exporter = Exporter(detection_crs="EPSG:2154")
    exporter.target_export_crs = "EPSG:2154"
    ctx = {"batch_name": "zone'29", "model_id": 3, "description": "run desc"}
    sq = geos.polygon([(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)])
    work = [{"geometry": sq, "class_id": 16, "confidence": 0.5},
            {"geometry": sq, "class_id": 16, "confidence": 0.25}]
    batch_id = exporter.export_to_db(db, work, ctx)
    db.close()
    srv.join(timeout=10)
    assert srv.error is None
    assert batch_id == 42
    assert srv.queries[0] == "BEGIN"
    assert srv.queries[1].startswith(
        "INSERT INTO detections.batch (id, batch_name, created_at, model_id, batch_tiles_url, "
        "description) VALUES(nextval('detections.batch_id_seq'::regclass), 'zone''29', ")
    assert srv.queries[1].rstrip(";").endswith("3, '', 'run desc') RETURNING id")
    assert srv.queries[2].startswith(
        "INSERT INTO detections.inference (batch_id, score, object_type, geometry) VALUES")
    assert "SRID=2154;POLYGON" in srv.queries[2] and "(42, " in srv.queries[2]
    assert srv.queries[3] == "COMMIT"


def test_pgwire_export_error_rolls_back():
    def handler(sql):
        if "RETURNING id" in sql:
            return [_row_desc(("id", 23)), _data_row(42), _complete("INSERT 0 1")]
        if "detections.inference" in sql:
            return [_error("permission denied for table inference")]
        return [_complete("SELECT 0")]

    srv = FakePG(handler)
    srv.start()
    db = _wire_db(srv)
    exporter = Exporter(detection_crs="EPSG:2154")
    exporter.target_export_crs = "EPSG:2154"
    sq = geos.polygon([(0, 0), (1, 0), (1, 1), (0, 1), (0, 0)])
    with pytest.raises(Exception, match="permission denied"):
        exporter.export_to_db(db, [{"geometry": sq, "class_id": 16, "confidence": 1.0}],
                              {"batch_name": "b", "model_id": 1, "description": ""})
    db.close()
    srv.join(timeout=10)
    assert srv.error is None
    assert srv.queries[-1] == "ROLLBACK"


def test_pgwire_model_registry_and_geozones():
    def handler(sql):
        if "detections.model" in sql:
            return [_row_desc(("id", 23), ("model_path", 25), ("name", 25)),
                    _data_row(3, "s3://bucket/models/m3", "swin"), _complete("SELECT 1")]
        if "fr_geozone_view" in sql:
            return [_row_desc(("id", 23), ("name", 25), ("geometry", 25),
                              ("geo_zone_type", 25), ("name_normalized", 25),
                              ("iso_code", 25)),
                    _data_row(1, "Brest", "POLYGON((0 0,1 0,1 1,0 1,0 0))", "commune",
                              "brest", "29019"),
                    _complete("SELECT 1")]
        return [_complete("SELECT 0")]

    srv = FakePG(handler)
    srv.start()
    db = _wire_db(srv)
    assert lookup_model_row(db, 3)["model_path"] == "s3://bucket/models/m3"
    zones = fetch_geozones(db)
    assert zones[0]["iso_code"] == "29019" and zones[0]["geometry"].startswith("POLYGON")
    assert any("ST_AsText(geometry)" in q for q in srv.queries)
    db.close()
    srv.join(timeout=10)
    assert srv.error is None


# --- the sqlite stand-in of tests/test_aigle_db.py ---------------------------


@pytest.fixture()
def db():
    d = Database.connect("sqlite://")
    d.execute("CREATE TABLE detections.batch (id INTEGER PRIMARY KEY, batch_name TEXT, "
              "created_at TEXT, model_id INTEGER, batch_tiles_url TEXT, description TEXT)")
    d.execute("CREATE TABLE detections.inference (batch_id INTEGER, score REAL, "
              "object_type TEXT, geometry TEXT)")
    yield d
    d.close()


def _records(n=7):
    return [{"geometry": geos_box(i, 0.0, i + 1.0, 1.0), "class_id": 6, "confidence": 0.1 * i}
            for i in range(n)]


def test_sql_quote_and_dsn():
    assert sql_quote("l'eau d'ici") == "l''eau d''ici"
    assert _parse_pg_dsn("postgresql://user:pw@dbhost:5433/aigle") == {
        "user": "user", "password": "pw", "host": "dbhost", "port": 5433, "database": "aigle"}


def test_live_export_transaction(db, tmp_path):
    exporter = Exporter(detection_crs="EPSG:2154")
    exporter.export_batch_size = 3  # several chunks
    ctx = {"export_sql": True, "batch_name": "zone d'essai", "model_id": 42,
           "description": "runner's batch"}
    mapper = Mapper({i: f"c{i}" for i in range(19)}, simplify=True)
    exporter.export_to_aigle(_records(), "EPSG:2154", str(tmp_path), mapper, ctx, db=db)
    batches = db.fetchall("select * from detections.batch")
    assert len(batches) == 1
    assert (batches[0]["batch_name"], batches[0]["model_id"]) == ("zone d'essai", 42)
    rows = db.fetchall("select * from detections.inference")
    assert len(rows) == 7
    assert all(r["batch_id"] == batches[0]["id"] for r in rows)
    assert rows[0]["geometry"].startswith("SRID=2154;POLYGON")
    assert any(f.endswith(".gpkg") for f in os.listdir(tmp_path))


def test_export_rollback_on_failure(db):
    exporter = Exporter(detection_crs="EPSG:2154")
    db.execute("DROP TABLE detections.inference")
    with pytest.raises(Exception):
        exporter.export_to_db(
            db, [{"geometry": geos_box(0, 0, 1, 1), "class_id": 16, "confidence": 0.5}],
            {"export_sql": True, "batch_name": "b", "model_id": 1, "description": ""})
    assert db.fetchall("select * from detections.batch") == []


def test_model_registry_lookup(db):
    db.execute("CREATE TABLE detections.model (id INTEGER PRIMARY KEY, model_path TEXT)")
    db.execute("INSERT INTO detections.model VALUES (7, 's3://bucket/m7')")
    assert lookup_model_row(db, 7)["model_path"] == "s3://bucket/m7"
    with pytest.raises(DatabaseError):
        lookup_model_row(db, 99)


def test_geozone_fallback_query(db, tmp_path, monkeypatch):
    from flair_for_aigle_tpu_torch.zonal.inference import load_geozone_contour

    db.execute("CREATE TABLE detections.fr_geozone_view (id INTEGER, name TEXT, geometry TEXT, "
               "geo_zone_type TEXT, name_normalized TEXT, iso_code TEXT)")
    db.execute("INSERT INTO detections.fr_geozone_view VALUES "
               "(1, 'Aix', 'POLYGON((0 0,2 0,2 2,0 2,0 0))', 'commune', 'aix', '13001'), "
               "(2, 'Nice', 'POLYGON((5 5,6 5,6 6,5 6,5 5))', 'commune', 'nice', '06088')")
    rows = fetch_geozones(db)
    assert len(rows) == 2 and rows[0]["iso_code"] == "13001"
    monkeypatch.setenv("GEOZONES_SHAPEFILE", "")

    class Cfg:
        db_sources = str(tmp_path)
        geozones_codes = "13001"
        input_crs = "EPSG:2154"

    geoms = load_geozone_contour(Cfg(), db=db)
    assert len(geoms) == 1 and geoms[0].bounds == (0.0, 0.0, 2.0, 2.0)


def test_missing_db_gives_clear_error(tmp_path, monkeypatch):
    from flair_for_aigle_tpu_torch.zonal.inference import load_geozone_contour

    monkeypatch.setenv("GEOZONES_SHAPEFILE", "absent.gpkg")
    monkeypatch.delenv("DB_STRING_PROD", raising=False)

    class Cfg:
        db_sources = str(tmp_path)

    with pytest.raises(FileNotFoundError, match="PostGIS fallback"):
        load_geozone_contour(Cfg())


# --- the driver against the JAX package's -----------------------------------

RES, PATCH, MARGIN, N_CLASSES, SIDE = 0.5, 64, 8, 19, 96
ARCH = "swin_micro_patch4_window12_384-upernet"
IMAGE_SET = "aigle_aerial_yolo_testzone_v1"
TOL = 1e-9  # EPSG:4326 coordinates of the batch GPKG, degrees


def _biased_checkpoint(path, favored=6):
    """Weights of one JAX init of the swin_micro-upernet whose
    segmentation-head bias makes ``favored`` every pixel's argmax
    (tests/test_aigle.py's recipe), written as safetensors."""
    import jax
    import jax.numpy as jnp
    from safetensors.numpy import save_file

    from flair_for_aigle_tpu.models.checkpoint import export_torch_state_dict
    from flair_for_aigle_tpu.models.flair_model import FlairHubModel
    from flair_for_aigle_tpu.zonal.model_utils import example_batch_for, prepare_model_config

    cfg = {"monotemp_arch": ARCH, "model_weights": "",
           "modalities": {"inputs": {"AERIAL_RGBI": True},
                          "AERIAL_RGBI": {"input_img_path": "", "channels": [1, 2, 3]}},
           "tasks": [{"name": "AERIAL_LABEL-COSIA", "active": True,
                      "class_names": {i: f"c{i}" for i in range(N_CLASSES)}}]}
    mc = prepare_model_config(cfg)
    model = FlairHubModel(config=mc)
    variables = jax.device_get(jax.jit(model.init)(
        jax.random.key(0), example_batch_for(mc, {"AERIAL_RGBI": PATCH}, 1)))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    bias = np.zeros(N_CLASSES, np.float32)
    bias[favored] = 50.0
    params["main_decoders.AERIAL_LABEL-COSIA.seg_model"]["segmentation_head"]["0"]["bias"] = \
        jnp.asarray(bias)
    sd = export_torch_state_dict({"params": params,
                                  "batch_stats": variables.get("batch_stats", {})})
    save_file({k: np.ascontiguousarray(v) for k, v in sd.items()}, path)


def _stage(root: Path, weights: str) -> str:
    """DATA_FOLDER and RUN_FOLDER under ``root`` with the two rasters and
    the staged model 7; returns the zonal YAML's path."""
    from flair_for_aigle_tpu.geo.geotiff import write_geotiff
    from flair_for_aigle_tpu.geo.windows import from_origin

    img_dir = root / "data" / IMAGE_SET / "raw-img"
    img_dir.mkdir(parents=True)
    rng = np.random.default_rng(0)
    for i in range(2):
        arr = rng.integers(0, 255, (3, SIDE, SIDE)).astype(np.uint8)
        write_geotiff(str(img_dir / f"zone_{i}.tif"), arr,
                      from_origin(700000 + i * 200, 6600000, RES, RES), "EPSG:2154")
    model_dir = root / "runs" / "models" / "7"
    model_dir.mkdir(parents=True)
    shutil.copy(weights, model_dir / "model.safetensors")
    zonal = {
        "output_path": str(root / "runs" / "unused"), "output_name": "aigle_zonal",
        "write_dataframe": False, "output_type": "argmax", "cog_conversion": False,
        "model_weights": "overridden", "batch_size": 2, "num_worker": 1,
        "img_pixels_detection": PATCH, "margin": MARGIN, "output_px_meters": RES,
        "monotemp_arch": ARCH, "multitemp_model_ref_date": "05-15",
        "modalities": {
            "inputs": {"AERIAL_RGBI": True, "AERIAL-RLT_PAN": False, "DEM_ELEV": False,
                       "SPOT_RGBI": False, "SENTINEL2_TS": False, "SENTINEL1-ASC_TS": False,
                       "SENTINEL1-DESC_TS": False},
            "AERIAL_RGBI": {"input_img_path": str(img_dir / "zone_0.tif"),
                            "channels": [1, 2, 3],
                            "normalization": {"type": "custom", "means": [105.0, 111.0, 102.0],
                                              "stds": [52.0, 45.0, 44.0]}},
        },
        "tasks": [{"name": "AERIAL_LABEL-COSIA", "active": True,
                   "class_names": {i: f"c{i}" for i in range(N_CLASSES)}}],
    }
    path = root / "zonal.yaml"
    path.write_text(yaml.safe_dump(zonal))
    return str(path)


def _run_args(root: Path, model_config: str) -> dict:
    return dict(debug_mode=True, images_type="aerial", tile_size_px=PATCH,
                geozones_codes="all", input_crs="EPSG:2154", target_crs="EPSG:4326",
                export_sql=True, dataset_type="yolo", images_folders=None,
                db_sources=str(root / "db"), s3_bucket_name=None,
                s3_aerial_archive_source_folder=None, s3_db_topo_archive_source_file=None,
                s3_run_folder_path=None, model_id=7, model_config=model_config,
                testset_name="testzone", version="v1", run_progression_filepath=None,
                run_id="t")


def _results(root: Path) -> Path:
    return root / "runs" / IMAGE_SET / "results"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' drivers on the same staged inputs."""
    from flair_for_aigle_tpu.aigle.run_fast_aigle_segmentation import (
        run_fast_aigle_segmentation as jax_run,
    )
    from flair_for_aigle_tpu_torch.aigle.run_fast_aigle_segmentation import (
        run_fast_aigle_segmentation,
    )

    base = tmp_path_factory.mktemp("aigle")
    weights = str(base / "weights.safetensors")
    _biased_checkpoint(weights)
    roots = {}
    mp = pytest.MonkeyPatch()
    mp.delenv("DB_STRING_PROD", raising=False)
    mp.delenv("GEOZONES_SHAPEFILE", raising=False)
    try:
        for name, run in (("jax", jax_run), ("torch", run_fast_aigle_segmentation)):
            root = base / name
            cfg = _stage(root, weights)
            mp.setenv("DATA_FOLDER", str(root / "data"))
            mp.setenv("RUN_FOLDER", str(root / "runs"))
            random.seed(0)
            if name == "jax":
                run(ArgsObject(**_run_args(root, cfg)))
            else:
                run(ArgsObject(**_run_args(root, cfg)), device="cpu")
            roots[name] = root
    finally:
        mp.undo()
    return roots, weights


def _gpkg(path):
    from flair_for_aigle_tpu_torch.geo.gpkg import read_gpkg

    return read_gpkg(str(path))


def _coords(g) -> list:
    if g.geom_type == "MultiPolygon":
        return [c for part in g.geoms for c in _coords(part)]
    return [np.asarray(g.exterior_coords())] + [np.asarray(r) for r in g.interiors_coords()]


def test_driver_label_rasters_are_the_jax_drivers(runs):
    from flair_for_aigle_tpu.geo.geotiff import open_raster

    roots, _ = runs
    names = sorted(f for f in os.listdir(_results(roots["jax"])) if f.endswith(".tif"))
    assert names == sorted(f for f in os.listdir(_results(roots["torch"]))
                           if f.endswith(".tif"))
    assert len(names) == 2
    for f in names:
        with open_raster(str(_results(roots["jax"]) / f)) as a, \
                open_raster(str(_results(roots["torch"]) / f)) as b:
            la, lb = a.read(), b.read()
        assert la.shape == (1, SIDE, SIDE)
        np.testing.assert_array_equal(lb, la)
        assert np.all(la == 6)


def test_driver_per_raster_gpkg_equals_the_jax_drivers(runs):
    roots, _ = runs
    for i in range(2):
        (got, crs_g), (want, crs_w) = (_gpkg(_results(roots[n]) / f"zone_{i}.gpkg")
                                       for n in ("torch", "jax"))
        assert crs_g == crs_w == "EPSG:2154"
        assert len(got) == len(want) >= 1
        for g, w in zip(got, want):
            assert g["class_id"] == w["class_id"] == 6
            assert g["geometry"].wkb == w["geometry"].wkb


def test_driver_batch_gpkg_equals_the_jax_drivers(runs):
    roots, _ = runs
    name = f"batch_segmentations_{IMAGE_SET}.gpkg"
    (got, crs_g), (want, crs_w) = (_gpkg(_results(roots[n]) / name) for n in ("torch", "jax"))
    assert crs_g == crs_w == "EPSG:4326"
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "geometry"} == \
            {k: v for k, v in w.items() if k != "geometry"}
        assert g["object_type"] == "plan d eau"
        assert g["geometry"].geom_type == w["geometry"].geom_type
        for a, b in zip(_coords(g["geometry"]), _coords(w["geometry"]), strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL)
        minx, miny, _, _ = g["geometry"].bounds
        assert -10 < minx < 10 and 40 < miny < 52


# the one time-dependent field of the SQL export: the batch's created_at
CREATED_AT = re.compile(r"'\d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d+)?'")


def test_driver_sql_equals_the_jax_drivers_but_created_at(runs):
    roots, _ = runs
    name = f"batch_segmentations_{IMAGE_SET}.sql"
    got, want = ((_results(roots[n]) / name).read_text().splitlines()
                 for n in ("torch", "jax"))
    assert any("INSERT INTO detections.inference" in line for line in got)
    assert sum(len(CREATED_AT.findall(line)) for line in got) == 1
    assert [CREATED_AT.sub("'<created_at>'", line) for line in got] == \
        [CREATED_AT.sub("'<created_at>'", line) for line in want]


def test_driver_rerun_skips_finished_rasters(runs, monkeypatch):
    from flair_for_aigle_tpu_torch.aigle import run_fast_aigle_segmentation as driver

    roots, _ = runs
    root = roots["torch"]
    monkeypatch.setenv("DATA_FOLDER", str(root / "data"))
    monkeypatch.setenv("RUN_FOLDER", str(root / "runs"))
    monkeypatch.delenv("DB_STRING_PROD", raising=False)
    monkeypatch.delenv("GEOZONES_SHAPEFILE", raising=False)

    def refuse(*a, **k):
        raise AssertionError("a finished raster went through inference again")

    monkeypatch.setattr(driver, "inference_and_write", refuse)
    monkeypatch.setattr(driver, "generate_patches_from_reference", refuse)
    driver.run_fast_aigle_segmentation(
        ArgsObject(**_run_args(root, str(root / "zonal.yaml"))), device="cpu")
    recs, _ = _gpkg(_results(root) / f"batch_segmentations_{IMAGE_SET}.gpkg")
    assert len(recs) == 2


def test_main_cli_drives_the_same_run_on_the_cpu(runs, tmp_path):
    roots, weights = runs
    root = tmp_path / "cli"
    run_cfg = {**_run_args(root, _stage(root, weights)),
               "process": "run_fast_best_segmentations"}
    cfg_path = tmp_path / "run.json"
    cfg_path.write_text(json.dumps(run_cfg))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("JAX_", "XLA_")) and k not in ("DB_STRING_PROD",
                                                             "GEOZONES_SHAPEFILE")}
    env.update(DATA_FOLDER=str(root / "data"), RUN_FOLDER=str(root / "runs"),
               PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-m", "flair_for_aigle_tpu_torch.main", "--config",
                           str(cfg_path), "--device", "cpu"], capture_output=True, text=True,
                          env=env, cwd=str(tmp_path), timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    name = f"batch_segmentations_{IMAGE_SET}.gpkg"
    (got, _), (want, _) = (_gpkg(_results(r) / name) for r in (root, roots["torch"]))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):  # scores are the unseeded placeholder
        assert g["object_type"] == w["object_type"]
        assert g["geometry"].wkb == w["geometry"].wkb
