# Copy of pointcloud_rl_tpu/utils/visualization.py for the PyTorch port.
"""Offline analysis visualizations (reference pyrl/utils/visualization role).

Matplotlib-based (headless-safe): point-cloud scatter renders, learning
curves from a work dir's metrics.csv, and simple value colormaps.  These are
analysis helpers, not part of the training hot path.
"""

from __future__ import annotations

import os.path as osp
from typing import List, Optional, Sequence

import numpy as np


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_pointcloud(
    xyz: np.ndarray,
    rgb: Optional[np.ndarray] = None,
    save_path: Optional[str] = None,
    elev: float = 30.0,
    azim: float = 45.0,
    point_size: float = 2.0,
):
    """Render a point cloud to an image. xyz: [N, 3] or channel-first [3, N]."""
    plt = _plt()
    xyz = np.asarray(xyz)
    if xyz.shape[0] == 3 and xyz.ndim == 2 and xyz.shape[1] != 3:
        xyz = xyz.T
    colors = None
    if rgb is not None:
        rgb = np.asarray(rgb)
        if rgb.shape[0] == 3 and rgb.ndim == 2 and rgb.shape[1] != 3:
            rgb = rgb.T
        colors = rgb / 255.0 if rgb.dtype == np.uint8 else np.clip(rgb, 0, 1)
    fig = plt.figure(figsize=(6, 6))
    ax = fig.add_subplot(111, projection="3d")
    ax.scatter(xyz[:, 0], xyz[:, 1], xyz[:, 2], c=colors, s=point_size)
    ax.view_init(elev=elev, azim=azim)
    ax.set_xlabel("x"), ax.set_ylabel("y"), ax.set_zlabel("z")
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
        return save_path
    return fig


def plot_learning_curves(
    metrics_csv: str,
    keys: Optional[Sequence[str]] = None,
    save_path: Optional[str] = None,
    smooth: int = 1,
):
    """Plot train curves from a run's logs/metrics.csv (CSV mirror)."""
    import csv

    plt = _plt()
    with open(metrics_csv) as f:
        rows = list(csv.DictReader(f))
    steps = np.asarray([float(r["step"]) for r in rows])
    if keys is None:
        keys = [k for k in rows[0] if k != "step" and any(s in k for s in ("rewards_mean", "critic_loss", "actor_loss"))]
    fig, axes = plt.subplots(1, max(len(keys), 1), figsize=(5 * max(len(keys), 1), 4), squeeze=False)
    for ax, key in zip(axes[0], keys):
        vals = np.asarray([float(r[key]) if r.get(key) else np.nan for r in rows])
        mask = ~np.isnan(vals)
        v, s = vals[mask], steps[mask]
        if smooth > 1 and len(v) >= smooth:
            kernel = np.ones(smooth) / smooth
            v = np.convolve(v, kernel, mode="valid")
            s = s[smooth - 1:]
        ax.plot(s, v)
        ax.set_title(key)
        ax.set_xlabel("env steps")
        ax.grid(alpha=0.3)
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=120)
        plt.close(fig)
        return save_path
    return fig


def values_to_colors(values: np.ndarray, cmap: str = "jet") -> np.ndarray:
    """Scalar array -> [N, 3] float colors (reference 2-D jet-colormap logging)."""
    import matplotlib.cm as cm

    values = np.asarray(values, np.float64)
    lo, hi = values.min(), values.max()
    norm = (values - lo) / max(hi - lo, 1e-9)
    return np.asarray(cm.get_cmap(cmap)(norm))[..., :3]


# ------------------------------------------------------- feature analysis
def kmeans(x: np.ndarray, n_clusters: Optional[int] = None, center: Optional[np.ndarray] = None,
           seed: int = 0):
    """K-means clustering of feature rows (reference visualization/cluster.py:5):
    fit when ``center`` is None, else assign to the given centers.
    Returns (center [K,D], pred [N], error [N])."""
    from sklearn.cluster import KMeans

    x = np.asarray(x)
    if center is None:
        km = KMeans(n_clusters=n_clusters, random_state=seed, n_init=10).fit(x)
        pred, center = km.labels_, km.cluster_centers_
    else:
        pred = np.argmin(np.linalg.norm(x[..., None, :] - center, axis=-1), axis=-1)
    error = np.linalg.norm(x - center[pred], axis=-1)
    return center, pred, error


def feature_similarity(feat1: np.ndarray, feat2: np.ndarray, batchsize: int = 400, k: int = 128) -> np.ndarray:
    """Per-row kNN-neighborhood IoU between two feature spaces (reference
    visualization/feat_sim.py:18): how much of each sample's k-nearest
    neighborhood is preserved across representations.  Returns [N] in [0,1]."""
    from sklearn.neighbors import KDTree

    feat1, feat2 = np.asarray(feat1), np.asarray(feat2)
    assert feat1.ndim == 2 and feat1.shape[0] == feat2.shape[0], f"{feat1.shape} {feat2.shape}"
    n = feat1.shape[0]
    k = min(k, n)
    kd1, kd2 = KDTree(feat1), KDTree(feat2)
    ious = np.empty(n, np.float64)
    for i in range(0, n, batchsize):
        sl = slice(i, min(n, i + batchsize))
        knn1 = kd1.query(feat1[sl], k=k)[1]
        knn2 = kd2.query(feat2[sl], k=k)[1]
        for r, (a, b) in enumerate(zip(knn1, knn2)):
            inter = len(np.intersect1d(a, b))
            ious[i + r] = inter / (2 * k - inter)
    return ious


def tsne_scatter(features: np.ndarray, labels: Optional[np.ndarray] = None,
                 save_path: Optional[str] = None, seed: int = 0, perplexity: float = 30.0):
    """2-D t-SNE embedding of feature rows, scatter-colored by ``labels``
    (reference cluster/e.g. t-SNE analysis plots; sklearn.manifold.TSNE
    replaces the reference's bokeh/cluster pipeline).  Returns the [N, 2]
    embedding (and saves a PNG when ``save_path`` is given)."""
    from sklearn.manifold import TSNE

    features = np.asarray(features)
    perplexity = min(perplexity, max(2.0, (len(features) - 1) / 3.0))
    emb = TSNE(n_components=2, random_state=seed, perplexity=perplexity,
               init="pca").fit_transform(features)
    if save_path:
        plt = _plt()
        fig, ax = plt.subplots(figsize=(6, 6))
        sc = ax.scatter(emb[:, 0], emb[:, 1], c=labels, s=8, cmap="tab10" if labels is not None else None)
        if labels is not None:
            fig.colorbar(sc, ax=ax, shrink=0.8)
        ax.set_title("t-SNE")
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return emb


_HTML_VIEWER = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>pointcloud</title><style>
body{margin:0;background:#111;color:#ccc;font:12px monospace}
#hud{position:fixed;top:6px;left:8px}</style></head>
<body><canvas id="c"></canvas><div id="hud">drag: orbit &middot; wheel: zoom</div>
<script>
const PTS=__PTS__, COL=__COL__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let W,H;function rs(){W=cv.width=innerWidth;H=cv.height=innerHeight;draw()}
addEventListener('resize',rs);
// center + scale
let cx=0,cy=0,cz=0;for(const p of PTS){cx+=p[0];cy+=p[1];cz+=p[2]}
cx/=PTS.length;cy/=PTS.length;cz/=PTS.length;
let r=0;for(const p of PTS){r=Math.max(r,Math.hypot(p[0]-cx,p[1]-cy,p[2]-cz))}
let yaw=.6,pitch=.4,zoom=1;
function draw(){
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const cyaw=Math.cos(yaw),syaw=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const s=.42*Math.min(W,H)/r*zoom, idx=[];
 for(let i=0;i<PTS.length;i++){
  const x=PTS[i][0]-cx,y=PTS[i][1]-cy,z=PTS[i][2]-cz;
  const x1=cyaw*x+syaw*y, y1=-syaw*x+cyaw*y;      // yaw about world z
  const y2=cp*y1-sp*z,   z2=sp*y1+cp*z;           // pitch
  idx.push([x1*s+W/2, H/2-z2*s, y2, i]);
 }
 idx.sort((a,b)=>b[2]-a[2]);                       // painter's order
 for(const [px,py,,i] of idx){
  ctx.fillStyle=COL?`rgb(${COL[i][0]},${COL[i][1]},${COL[i][2]})`:'#6cf';
  ctx.fillRect(px-1.5,py-1.5,3,3);
 }}
let drag=null;
cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*.008;
 pitch=Math.max(-1.5,Math.min(1.5,pitch+(e.clientY-drag[1])*.008));
 drag=[e.clientX,e.clientY];draw()};
cv.onwheel=e=>{zoom*=e.deltaY<0?1.1:.9;draw();e.preventDefault()};
rs();
</script></body></html>
"""


def pointcloud_html(xyz: np.ndarray, rgb: Optional[np.ndarray] = None,
                    path: str = "pointcloud.html", max_points: int = 20000) -> str:
    """Self-contained interactive point-cloud viewer (reference
    pyrl/utils/visualization o3d interactive-viewer role, rebuilt without
    open3d: a single HTML file with a canvas orbit/zoom renderer — works
    over SSH/headless, open in any browser).

    xyz: [N, 3] (or [3, N] channel-first); rgb: matching uint8 colors.
    Returns the written path."""
    xyz = np.asarray(xyz, np.float32)
    if xyz.ndim != 2:
        raise ValueError(f"xyz must be 2-D, got {xyz.shape}")
    if xyz.shape[0] == 3 and xyz.shape[1] != 3:
        xyz = xyz.T
        if rgb is not None:
            rgb = np.asarray(rgb).T
    if len(xyz) > max_points:
        sel = np.random.RandomState(0).choice(len(xyz), max_points, replace=False)
        xyz = xyz[sel]
        rgb = rgb[sel] if rgb is not None else None
    pts = [[round(float(v), 4) for v in p] for p in xyz]
    col = [[int(v) for v in c] for c in np.asarray(rgb)] if rgb is not None else None
    import json

    html = _HTML_VIEWER.replace("__PTS__", json.dumps(pts)).replace(
        "__COL__", json.dumps(col))
    with open(path, "w") as f:
        f.write(html)
    return path
