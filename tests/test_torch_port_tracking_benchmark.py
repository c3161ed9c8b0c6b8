"""The port's CTC tracking benchmark (``viscy_tpu_torch.apps.dynaclr.
tracking_benchmark`` and ``evaluate-tracking-accuracy -c``) against
``viscy_tpu.apps.dynaclr.tracking_benchmark``, on the CPU.

- The TIFF codec: round trips bit for bit against imageio and PIL both
  ways, a big-endian file, and the refusal of a compressed one.
- Nodes, candidate edges, the ILP's solution (on instances with a unique
  optimum: continuous costs), every CTC metric, ``track_arrays`` end to end
  and the CSVs' text equal JAX's; the objective within 1e-12 relative.
- Tiny ``convnext`` / ``convnextv2`` encoders from JAX's params through the
  flax bridge: node embeddings within the encoder tests' bound (2e-3 of
  range, r > 0.9999), also for a last batch shorter than ``batch_size`` (JAX pads it).
- ``-c`` through both CLIs on a tiny sequence; a sequence whose embedder
  fails raises in the port where JAX leaves it out of ``results.csv``.
"""

import math
import sys
import types

import imageio.v3 as iio
import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import yaml
from click.testing import CliRunner
from PIL import Image

from viscy_tpu.apps.dynaclr import cli as jcli
from viscy_tpu.apps.dynaclr import tracking_benchmark as J
from viscy_tpu.apps.dynaclr.tracking_benchmark import ctc as jctc
from viscy_tpu.apps.dynaclr.tracking_benchmark import embedding as jemb
from viscy_tpu.apps.dynaclr.tracking_benchmark import evaluate as jev
from viscy_tpu.apps.dynaclr.tracking_benchmark import metrics as jmet
from viscy_tpu.models.contrastive.encoder import ContrastiveEncoder as JEncoder
from viscy_tpu_torch.apps.dynaclr import cli as tcli
from viscy_tpu_torch.apps.dynaclr import tracking_benchmark as P
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import ctc as pctc
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import embedding as pemb
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import evaluate as pev
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark import metrics as pmet
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.solver import ilp_problem
from viscy_tpu_torch.apps.dynaclr.tracking_benchmark.synthetic import ctc_sequence
from viscy_tpu_torch.data.tiff import UnsupportedTiffError, read_tiff, write_tiff
from viscy_tpu_torch.training.cli_utils import rows_to_csv
from viscy_tpu_torch.models.contrastive.encoder import ContrastiveEncoder
from viscy_tpu_torch.training.convert import load_flax_params

from _torch_port_helpers import assert_rel_close, seeded_params

SMALL = dict(frames=8, side=96, cells=4, radius=7.0, divisions=1, drops=1, merges=1)
GRAPH = dict(distance_threshold=40.0, n_neighbors=4, delta_t=3)
ENCODER = dict(in_channels=1, in_stack_depth=1, stem_kernel_size=(1, 4, 4), stem_stride=(1, 4, 4),
               embedding_dim=32, projection_dim=16)


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = tmp_path_factory.mktemp("ctc") / "ds"
    return root, ctc_sequence(root, seed=3, **SMALL)


def _cfg(mod, root, out, models=None, **kw):
    return mod.TrackingAccuracyConfig(models=models or [{"path": None, "label": "baseline"}],
                                      datasets=[{"path": str(root), "sequences": ["01"]}], output_dir=str(out),
                                      model_input_shape=(32, 32), batch_size=4, **{**GRAPH, **kw})


def _frame(nodes) -> dict:
    return {c: nodes[c].to_numpy() for c in nodes.columns}


def _assert_columns_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
        assert np.asarray(got[k]).dtype.kind == np.asarray(want[k]).dtype.kind or len(want[k]) == 0, k


def _metrics_equal(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for k in want:
        assert got[k] == want[k] or (math.isnan(got[k]) and math.isnan(want[k])), (k, got[k], want[k])


# -- the TIFF codec ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.int32, np.float32])
def test_tiff_round_trips_against_imageio_and_pil(tmp_path, dtype):
    rng = np.random.default_rng(1)
    a = (rng.random((300, 517)) * 1000 - (100 if dtype in (np.int32, np.float32) else 0)).astype(dtype)
    write_tiff(tmp_path / "port.tif", a)
    for got in (iio.imread(tmp_path / "port.tif"), np.asarray(Image.open(tmp_path / "port.tif"))):
        assert got.dtype == a.dtype
        np.testing.assert_array_equal(got, a)
    iio.imwrite(tmp_path / "imageio.tif", a)
    Image.fromarray(a).save(tmp_path / "pil.tif")
    for name in ("imageio.tif", "pil.tif"):
        back = read_tiff(tmp_path / name)
        assert back.dtype == a.dtype
        np.testing.assert_array_equal(back, a)


def test_tiff_reads_big_endian_and_refuses_compression(tmp_path):
    a = (np.random.default_rng(2).random((64, 70)) * 60000).astype(np.uint16)
    Image.frombuffer("I;16B", (70, 64), a.astype(">u2").tobytes(), "raw", "I;16B", 0, 1).save(tmp_path / "be.tif")
    assert (tmp_path / "be.tif").read_bytes()[:2] == b"MM"
    np.testing.assert_array_equal(read_tiff(tmp_path / "be.tif"), a)
    Image.fromarray(a).save(tmp_path / "packbits.tif", compression="packbits")
    with pytest.raises(UnsupportedTiffError, match=r"Compression = 32773 \(PackBits\)"):
        read_tiff(tmp_path / "packbits.tif")
    # the compression tag of an uncompressed file set to LZW
    write_tiff(tmp_path / "lzw.tif", a)
    buf = bytearray((tmp_path / "lzw.tif").read_bytes())
    entry = 8 + 2 + 12 * 3  # the IFD's fourth entry: tag 259
    assert int.from_bytes(buf[entry:entry + 2], "little") == 259
    buf[entry + 8:entry + 10] = (5).to_bytes(2, "little")
    (tmp_path / "lzw.tif").write_bytes(bytes(buf))
    with pytest.raises(UnsupportedTiffError, match=r"Compression = 5 \(LZW\)"):
        read_tiff(tmp_path / "lzw.tif")
    with pytest.raises(UnsupportedTiffError, match="uint8, uint16, int32 or float32"):
        write_tiff(tmp_path / "f64.tif", a.astype(np.float64))


def test_ctc_io_matches_jax(seq, tmp_path):
    root, data = seq
    jgt = jctc.load_ctc_ground_truth(root / "01_GT" / "TRA")
    pgt = pctc.load_ctc_ground_truth(root / "01_GT" / "TRA")
    np.testing.assert_array_equal(pgt.masks, jgt.masks)
    _assert_columns_equal(pgt.tracks, _frame(jgt.tracks))
    _assert_columns_equal(pgt.edges(), _frame(jgt.edges()))
    np.testing.assert_array_equal(pctc.load_tiff_stack(root / "01"), jctc.load_tiff_stack(root / "01"))
    pctc.write_ctc_result(tmp_path / "p", pgt.masks, pgt.tracks)
    jctc.write_ctc_result(tmp_path / "j", jgt.masks, jgt.tracks)
    assert (tmp_path / "p/res_track.txt").read_text() == (tmp_path / "j/res_track.txt").read_text()
    assert sorted(f.name for f in (tmp_path / "p").iterdir()) == sorted(f.name for f in (tmp_path / "j").iterdir())
    np.testing.assert_array_equal(jctc.load_tiff_stack(tmp_path / "p", "mask*.tif"),
                                  pctc.load_tiff_stack(tmp_path / "j", "mask*.tif"))


# -- graph, solver, metrics -------------------------------------------------------------------


def test_nodes_and_edges_match_jax(seq):
    _, data = seq
    for labels in (data["seg"], data["gt"], np.stack([data["gt"][:, :2], data["gt"][:, 2:4]], axis=1)):
        jn, jpix = J.extract_nodes(labels)
        pn, ppix = P.extract_nodes(labels)
        _assert_columns_equal(pn, _frame(jn))
        assert list(ppix) == list(jpix)
        for k in jpix:
            np.testing.assert_array_equal(ppix[k], jpix[k])
    jg = J.build_candidate_graph(data["seg"], **GRAPH)
    pg = P.build_candidate_graph(data["seg"], **GRAPH)
    _assert_columns_equal(pg.edges, _frame(jg.edges))
    J.evaluate.add_iou_attr(jg)
    P.graph.add_iou_attr(pg)
    np.testing.assert_array_equal(pg.edges["iou"], jg.edges["iou"].to_numpy())
    assert P.build_candidate_graph(np.zeros((2, 8, 8), np.uint16)).num_edges() == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ilp_solution_matches_jax_at_a_unique_optimum(seq, seed):
    """Random continuous edge costs make the optimum unique: the same
    selected nodes, edges and tracks as JAX's MILP, the objective within
    1e-12, and the port's solution satisfies the flow constraints."""
    _, data = seq
    jg = J.build_candidate_graph(data["seg"], **GRAPH)
    pg = P.build_candidate_graph(data["seg"], **GRAPH)
    w = -np.random.default_rng(seed).uniform(0.05, 1.0, pg.num_edges())
    jg.edges["weight"] = w
    pg.edges["weight"] = w
    kw = dict(division_weight=0.3 + 0.2 * seed, node_weight=-2.0)
    jsol = J.solve_tracking(jg, **kw)
    info: dict = {}
    psol = P.solve_tracking(pg, solution=info, **kw)
    _assert_columns_equal(psol.nodes, _frame(jsol.nodes))
    _assert_columns_equal(psol.edges, _frame(jsol.edges))
    _assert_columns_equal(psol.tracks, _frame(jsol.tracks))
    c, A, lb, ub = ilp_problem(pg, **kw)
    ax = A @ info["x"]
    assert np.all(ax >= lb) and np.all(ax <= ub)
    from scipy.optimize import Bounds, LinearConstraint, milp

    want = milp(c=c, constraints=LinearConstraint(A, lb, ub), integrality=np.ones(len(c)), bounds=Bounds(0, 1)).fun
    assert info["objective"] == pytest.approx(want, rel=1e-12)


def test_every_ctc_metric_matches_jax(seq):
    """Results of three kinds against the GT: the baseline's tracking of the
    error segmentation, the GT itself, and the GT with a track split and a
    parent dropped."""
    root, data = seq
    gt = pctc.load_ctc_ground_truth(root / "01_GT" / "TRA")
    cfg = _cfg(P, root, "unused")
    g, sol = pev.track_arrays(data["raw"], data["seg"], cfg)
    res_masks, res_tracks = pctc.tracking_to_ctc(sol, g.node_pixels, g.frame_shape, len(data["seg"]))
    split = gt.masks.copy()
    split[4:][split[4:] == 1] = 99
    split[split == 2] = 0
    tracks = dict(gt.tracks)
    tracks = {k: np.append(v, {"track_id": 99, "t_start": 4, "t_end": 7, "parent_track": 1}[k]) for k, v in tracks.items()}
    cases = [(res_masks, res_tracks), (gt.masks, gt.tracks), (split, tracks), (gt.masks[:5], gt.tracks)]
    for masks, tr in cases:
        want = jmet.evaluate_ctc_metrics(jmet.TrackingAnnotation(masks, pd.DataFrame(tr)),
                                         jmet.TrackingAnnotation(gt.masks, pd.DataFrame(gt.tracks)))
        got = pmet.evaluate_ctc_metrics(pmet.TrackingAnnotation(masks, tr), pmet.TrackingAnnotation(gt.masks, gt.tracks))
        _metrics_equal(got, want)
    sub = ["TRA", "OP_CLB(0)", "CHOTA"]
    _metrics_equal(pmet.evaluate_ctc_metrics(pmet.TrackingAnnotation(*cases[0]), pmet.TrackingAnnotation(*cases[1]),
                                             sub),
                   jmet.evaluate_ctc_metrics(jmet.TrackingAnnotation(cases[0][0], pd.DataFrame(cases[0][1])),
                                             jmet.TrackingAnnotation(gt.masks, pd.DataFrame(gt.tracks)), sub))


def _stub_embed(batch):
    x = batch[:, 0, 0]
    return np.stack([x.mean((1, 2)), x.std((1, 2)), np.abs(x).mean((1, 2)) + 1.0, x.max((1, 2))], axis=1)


@pytest.mark.parametrize("embedder", [None, _stub_embed])
@pytest.mark.parametrize("scale", [1.0, 1.3])
def test_track_arrays_matches_jax_end_to_end(seq, embedder, scale):
    """The baseline and a deterministic stub embedder, at the model's pixel
    size and at another (crops resized by JAX's bilinear rule): the
    weights, the solution and the metrics equal JAX's."""
    root, data = seq
    jg, jsol = jev.track_arrays(data["raw"], data["seg"], _cfg(J, root, "u"), embed_fn=embedder,
                                pixel_size_scale=scale)
    pg, psol = pev.track_arrays(data["raw"], data["seg"], _cfg(P, root, "u"), embed_fn=embedder,
                                pixel_size_scale=scale)
    _assert_columns_equal(pg.edges, _frame(jg.edges))
    _assert_columns_equal(psol.tracks, _frame(jsol.tracks))
    if embedder is not None:
        np.testing.assert_array_equal(
            pemb.node_crops(pg, data["raw"], (32, 32), scale)[:5],
            np.stack([jemb.crop_node(data["raw"][int(t)], (y, x), (round(32 * scale),) * 2, (32, 32),
                                     float(data["raw"][int(t)].astype(np.float32).mean()),
                                     float(data["raw"][int(t)].astype(np.float32).std()))
                      for t, y, x in zip(pg.nodes["t"][:5], pg.nodes["y"][:5], pg.nodes["x"][:5])]))


# -- the encoders -----------------------------------------------------------------------------


def _encoders(backbone: str, seed: int):
    jmod = JEncoder(backbone=backbone, **ENCODER)
    shapes = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(0), jnp.zeros((1, 1, 1, 32, 32))))
    rng = np.random.default_rng(seed + 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, s: (rng.normal(0, 0.1, s.shape) if path[-1].key == "mean" else rng.uniform(0.5, 1.5, s.shape))
        .astype(np.float32), shapes.get("batch_stats", {}))
    params = seeded_params(shapes["params"], seed)
    variables = {"params": jax.tree_util.tree_map(jnp.asarray, params),
                 "batch_stats": jax.tree_util.tree_map(jnp.asarray, stats)}
    model = ContrastiveEncoder(backbone=backbone, **ENCODER)
    load_flax_params(model, params, stats)
    return jemb.make_flax_embedder(jmod.apply, variables), model


@pytest.fixture(autouse=True)
def _no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


@pytest.mark.parametrize("backbone", ["convnext_test", "convnextv2_test"])
def test_node_embeddings_match_the_flax_encoder(seq, backbone):
    """Node embeddings within 2e-3 of range and r > 0.9999 of the flax
    encoder's; the nodes (35) are no multiple of the batch (4 and 16): JAX
    zero-pads the last batch, the port does not, and in eval mode the
    padding changes nothing."""
    root, data = seq
    jfn, model = _encoders(backbone, 5)
    pfn = pemb.make_torch_embedder(model, "cpu")
    graph = P.build_candidate_graph(data["seg"], **GRAPH)
    jgraph = J.build_candidate_graph(data["seg"], **GRAPH)
    assert graph.num_nodes() % 4 and graph.num_nodes() % 16
    want = jemb.compute_node_embeddings(jgraph, data["raw"], jfn, model_input_shape=(32, 32), batch_size=4)
    for batch in (4, 16):
        got = pemb.compute_node_embeddings(graph, data["raw"], pfn, model_input_shape=(32, 32), batch_size=batch)
        assert_rel_close(got, want, 2e-3, 0.9999)
    if not torch.cuda.is_available():  # no fallback to the CPU
        with pytest.raises(RuntimeError, match="is_available"):
            pemb.make_torch_embedder(model, "cuda")


# -- config, CLI, departures ------------------------------------------------------------------


def test_config_defaults_and_refusals_match_jax(tmp_path):
    raw = dict(models=[{"path": None, "label": "b"}], datasets=[{"path": "x"}], output_dir="o")
    j, p = J.TrackingAccuracyConfig(**raw), P.TrackingAccuracyConfig(**raw)
    for name in ("model_input_shape", "distance_threshold", "n_neighbors", "delta_t", "division_weight",
                 "appearance_weight", "disappearance_weight", "node_weight", "ctc_metrics", "batch_size",
                 "solver_time_limit", "ctc_metadata_path"):
        assert getattr(p, name) == getattr(j, name), name
    assert p.datasets[0].sequences == j.datasets[0].sequences == ["01", "02"]
    assert p.models[0].model_init_args == {} and p.models[0].pixel_size_um is None
    for bad, field in ((dict(raw, models=[]), "models"), (dict(raw, n_neighbors="many"), "n_neighbors"),
                       (dict(raw, models=[{"path": None}]), "label"), ({**raw, "output_dir": None}, "output_dir"),
                       (dict(raw, model_input_shape=[1, 2, 3]), "model_input_shape")):
        with pytest.raises(ValueError, match=field):
            P.TrackingAccuracyConfig(**bad)
    (tmp_path / "orbax").mkdir()
    entry = P.EmbeddingModelEntry(path=str(tmp_path / "orbax"), label="m", model_class="viscy_tpu.models."
                                  "contrastive.encoder.ContrastiveEncoder")
    with pytest.raises(ValueError, match="Orbax"):
        pev.resolve_embed_fn(entry, "cpu")
    with pytest.raises(ValueError, match="model_class"):
        pev.resolve_embed_fn(P.EmbeddingModelEntry(path=str(tmp_path / "w.pt"), label="m"), "cpu")


def _register_factory(name: str, fn) -> str:
    mod = types.ModuleType(name)
    mod.factory = lambda: fn
    sys.modules[name] = mod
    return f"{name}:factory"


def test_the_cli_matches_jax_and_loads_a_torch_checkpoint(seq, tmp_path, monkeypatch):
    """``-c`` of the baseline, a stub factory and (port) a ``.pt`` encoder
    checkpoint: results.csv and summary.csv as JAX writes them; the
    checkpoint's rows equal a direct run of the same encoder."""
    root, data = seq
    spec = _register_factory("_ctc_stub_embedder", _stub_embed)
    models = [{"path": None, "label": "baseline"}, {"path": spec, "label": "stub"}]
    cfg = dict(models=models, datasets=[{"path": str(root), "sequences": ["01", "02"]}],
               model_input_shape=[32, 32], batch_size=4, **GRAPH)
    runner = CliRunner()
    for name, cli, pre in (("j", jcli.main, []), ("t", tcli.main, ["--device", "cpu"])):
        (tmp_path / f"{name}.yml").write_text(yaml.safe_dump(dict(cfg, output_dir=str(tmp_path / name))))
        res = runner.invoke(cli, [*pre, "evaluate-tracking-accuracy", "-c", str(tmp_path / f"{name}.yml")],
                            catch_exceptions=False)
        assert res.exit_code == 0, res.output
    for f in ("results.csv", "summary.csv"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text(), f
    _, model = _encoders("convnextv2_test", 7)
    torch.save(model.state_dict(), tmp_path / "enc.pt")
    init = {k: list(v) if isinstance(v, tuple) else v for k, v in ENCODER.items()}
    entry = {"path": str(tmp_path / "enc.pt"), "label": "enc", "model_init_args": dict(backbone="convnextv2_test", **init),
             "model_class": "viscy_tpu.models.contrastive.encoder.ContrastiveEncoder"}
    (tmp_path / "c.yml").write_text(yaml.safe_dump(dict(cfg, models=[entry], output_dir=str(tmp_path / "c"))))
    res = runner.invoke(tcli.main, ["--device", "cpu", "evaluate-tracking-accuracy", "-c", str(tmp_path / "c.yml")],
                        catch_exceptions=False)
    assert res.exit_code == 0 and "Results written to" in res.output
    monkeypatch.setitem(sys.modules, "_ctc_torch_embedder",
                        types.SimpleNamespace(factory=lambda: pemb.make_torch_embedder(model, "cpu")))
    direct = pev.track_single_dataset(P.CTCDatasetEntry(path=str(root), sequences=["01"]), "01",
                                      P.EmbeddingModelEntry(path="_ctc_torch_embedder:factory", label="enc"),
                                      _cfg(P, root, "u"), device="cpu")
    assert (tmp_path / "c" / "results.csv").read_text() == rows_to_csv([direct])


def test_a_failing_sequence_raises_where_jax_leaves_it_out(seq, tmp_path):
    root, _ = seq

    def broken(batch):
        raise RuntimeError("the encoder failed")

    spec = _register_factory("_ctc_broken_embedder", broken)
    models = [{"path": None, "label": "baseline"}, {"path": spec, "label": "broken"}]
    jrows = jev.run_tracking_accuracy(_cfg(J, root, tmp_path / "j", models=models))
    assert list(jrows["model"]) == ["baseline"]  # JAX logged the failure and went on
    with pytest.raises(RuntimeError, match="tracking failed: broken") as err:
        pev.run_tracking_accuracy(_cfg(P, root, tmp_path / "t", models=models), device="cpu")
    assert "the encoder failed" in str(err.value.__cause__)
    # the sequence before it was written, as in JAX
    assert (tmp_path / "t" / "results.csv").read_text() == (tmp_path / "j" / "results.csv").read_text()
