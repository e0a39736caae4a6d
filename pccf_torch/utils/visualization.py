"""Rendering (``pccf/utils/visualization.py``, copied: the JAX package's
module imports nothing of JAX, but the port keeps its own copy).

The same software sphere rasteriser (numpy) and self-contained HTML orbit
viewer as the JAX package, bit for bit, for ``visualize_counterfactuals``,
``generate``'s images and the classifier's confusion-matrix figure.  The PNG
is written through matplotlib, as JAX writes it; where matplotlib does not
import (the card's machine has none), :func:`render_cloud` logs one line,
writes no PNG and writes the HTML viewer into ``save_dir`` instead, so a
render still leaves a file.
"""

from __future__ import annotations

import json
import logging
import pathlib
import re
from typing import Any, Sequence

import numpy as np

logger = logging.getLogger(__name__)

BLUE = np.array([0.3, 0.3, 0.9])
RED = np.array([0.9, 0.3, 0.3])
GREEN = np.array([0.3, 0.9, 0.3])
VIOLET = np.array([0.6, 0.0, 0.9])
ORANGE = np.array([0.9, 0.6, 0.0])
COLOR_TUPLE = (BLUE, RED, GREEN, VIOLET, ORANGE)

# Reference camera (visualization.py:44): eye, focal point, view-up.
_EYE = np.array([-3.0, 1.0, -2.5])
_UP = np.array([0.0, 1.0, 0.0])
# Reference lights (visualization.py:46): positional at these points.
_LIGHTS = (np.array([3.0, 3.0, -2.0]), np.array([3.0, 3.0, 2.0]))


def _slug(title: str) -> str:
    return re.sub(r'[^A-Za-z0-9_.-]+', '_', title)[:120] or 'cloud'


def _cloud_colors(n_clouds: int, colorscale: str) -> list[np.ndarray]:
    if colorscale == 'blue_red':
        if n_clouds == 1:
            return [BLUE]
        return [
            (1 - i / (n_clouds - 1)) * BLUE + i / (n_clouds - 1) * RED
            for i in range(n_clouds)
        ]
    if colorscale == 'sequence':
        return [COLOR_TUPLE[i % len(COLOR_TUPLE)] for i in range(n_clouds)]
    raise ValueError(f'Colorscale not available: {colorscale!r}')


def _camera_rotation() -> np.ndarray:
    """World->camera rotation rows (right, up, -forward); camera looks -z."""
    fwd = -_EYE / np.linalg.norm(_EYE)  # toward the focal point (origin)
    right = np.cross(fwd, _UP)
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    return np.stack([right, up, -fwd])


def _arrows_to_spheres(
    cloud: np.ndarray, arrows: np.ndarray, radius: float
) -> tuple[np.ndarray, np.ndarray]:
    """Sample arrow glyphs (shaft + tapered tip) as sphere centres/radii."""
    base = np.asarray(cloud)[:, :3]
    vec = np.asarray(arrows)[:, :3]
    n_shaft, n_tip = 6, 3
    ts = np.linspace(0.0, 0.75, n_shaft)
    tt = np.linspace(0.78, 1.0, n_tip)
    pts = np.concatenate(
        [base[:, None, :] + t * vec[:, None, :] for t in ts]
        + [base[:, None, :] + t * vec[:, None, :] for t in tt],
        axis=1,
    ).reshape(-1, 3)
    radii = np.concatenate(
        [np.full(n_shaft, radius * 0.7), radius * 1.8 * np.linspace(1.0, 0.2, n_tip)]
    )
    radii = np.tile(radii, len(base))
    return pts, radii


def _rasterize(
    clouds: Sequence[np.ndarray],
    colors: Sequence[np.ndarray],
    radii: Sequence[np.ndarray],
    size: int = 1024,
) -> np.ndarray:
    """Z-buffered sphere splatting with two-light Lambertian shading.

    Returns an RGBA float image; background is transparent, matching the
    reference's ``screenshot(..., transparent_background=True)``.
    """
    rot = _camera_rotation()
    half = size / 2.0
    focal = half / np.tan(np.deg2rad(15.0))  # ~30 deg vertical FOV
    light_dirs = [rot @ (light / np.linalg.norm(light)) for light in _LIGHTS]

    img = np.zeros((size, size, 3))
    alpha = np.zeros((size, size))
    zbuf = np.full((size, size), np.inf)

    for cloud, color, rads in zip(clouds, colors, radii):
        pts = np.asarray(cloud, dtype=np.float64)[:, :3]
        if not len(pts):
            continue
        cam = (pts - _EYE) @ rot.T
        depth = -cam[:, 2]
        ok = depth > 1e-3
        cam, depth, rads_v = cam[ok], depth[ok], np.broadcast_to(rads, (len(pts),))[ok]
        sx = half + focal * cam[:, 0] / depth
        sy = half - focal * cam[:, 1] / depth
        rpix = np.maximum(focal * rads_v / depth, 0.75)
        for i in range(len(cam)):
            r = int(np.ceil(rpix[i]))
            x0, x1 = int(sx[i]) - r, int(sx[i]) + r + 1
            y0, y1 = int(sy[i]) - r, int(sy[i]) + r + 1
            if x1 <= 0 or y1 <= 0 or x0 >= size or y0 >= size:
                continue
            cx0, cy0 = max(x0, 0), max(y0, 0)
            cx1, cy1 = min(x1, size), min(y1, size)
            ys, xs = np.mgrid[cy0:cy1, cx0:cx1]
            nx = (xs + 0.5 - sx[i]) / rpix[i]
            ny = -(ys + 0.5 - sy[i]) / rpix[i]
            n2 = nx * nx + ny * ny
            inside = n2 < 1.0
            if not inside.any():
                continue
            nz = np.sqrt(np.clip(1.0 - n2, 0.0, 1.0))
            # per-pixel sphere depth: nearer at the centre of the splat
            d_pix = depth[i] - nz * rads_v[i]
            # ambient + camera headlight (pyvista's 'three lights' rig is
            # camera-tied) + the two reference scene lights
            shade = 0.25 + 0.55 * nz + sum(
                0.35 * np.clip(nx * ld[0] + ny * ld[1] + nz * ld[2], 0.0, None)
                for ld in light_dirs
            )
            win = inside & (d_pix < zbuf[cy0:cy1, cx0:cx1])
            zbuf[cy0:cy1, cx0:cx1][win] = d_pix[win]
            img[cy0:cy1, cx0:cx1][win] = np.clip(
                shade[win, None] * color[None, :], 0.0, 1.0
            )
            alpha[cy0:cy1, cx0:cx1][win] = 1.0
    return np.concatenate([img, alpha[..., None]], axis=-1)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
 body{margin:0;background:#fff;font:13px sans-serif;overflow:hidden}
 #hud{position:fixed;top:8px;left:10px;color:#333;user-select:none}
 .sw{display:inline-block;width:10px;height:10px;margin:0 4px 0 10px;border-radius:5px}
 #help{position:fixed;bottom:8px;left:10px;color:#999}
</style></head><body>
<canvas id="c"></canvas><div id="hud"><b>__TITLE__</b><span id="legend"></span></div>
<div id="help">drag: orbit &nbsp; wheel: zoom &nbsp; shift-drag: pan</div>
<script>
const CLOUDS=__DATA__;
const cv=document.getElementById('c'),ctx=cv.getContext('2d');
let yaw=-2.27,pitch=0.24,dist=3.9,panX=0,panY=0;
function resize(){cv.width=innerWidth;cv.height=innerHeight;draw()}
addEventListener('resize',resize);
let drag=null;
cv.addEventListener('mousedown',e=>drag=[e.clientX,e.clientY,e.shiftKey]);
addEventListener('mouseup',()=>drag=null);
addEventListener('mousemove',e=>{if(!drag)return;const dx=e.clientX-drag[0],dy=e.clientY-drag[1];
 if(drag[2]){panX+=dx*dist/600;panY+=dy*dist/600}else{yaw+=dx*.008;pitch=Math.max(-1.5,Math.min(1.5,pitch+dy*.008))}
 drag=[e.clientX,e.clientY,drag[2]];draw()});
cv.addEventListener('wheel',e=>{e.preventDefault();dist*=Math.exp(e.deltaY*.001);draw()},{passive:false});
function draw(){
 const w=cv.width,h=cv.height,f=h/(2*Math.tan(Math.PI/12));
 ctx.clearRect(0,0,w,h);
 const cy1=Math.cos(yaw),sy1=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
 const items=[];
 for(const cl of CLOUDS){const p=cl.pts,col=cl.rgb;
  for(let i=0;i<p.length;i+=3){
   const x=p[i],y=p[i+1],z=p[i+2];
   let rx=cy1*x+sy1*z, rz=-sy1*x+cy1*z;
   let ry=cp*y-sp*rz; rz=sp*y+cp*rz;
   const d=dist+rz; if(d<0.05)continue;
   items.push([d,(rx+panX)*f/d+w/2,h/2-(ry-panY)*f/d,col]);
 }}
 items.sort((a,b)=>b[0]-a[0]);
 for(const[d,sx,sy,col]of items){
  const r=Math.max(1.2,f*0.011/d),s=Math.max(.45,1.25-d*.18);
  ctx.fillStyle='rgb('+(col[0]*s*255|0)+','+(col[1]*s*255|0)+','+(col[2]*s*255|0)+')';
  ctx.beginPath();ctx.arc(sx,sy,r,0,6.2832);ctx.fill();
 }}
const lg=document.getElementById('legend');
CLOUDS.forEach((cl,i)=>{const sw=document.createElement('span');sw.className='sw';
 sw.style.background='rgb('+(cl.rgb[0]*255|0)+','+(cl.rgb[1]*255|0)+','+(cl.rgb[2]*255|0)+')';
 lg.appendChild(sw);
 /* textContent, not innerHTML: cloud names are user data, never markup */
 lg.appendChild(document.createTextNode(cl.name||('cloud '+i)))});
resize();
</script></body></html>
"""


def write_html_viewer(
    clouds: Sequence[np.ndarray],
    colors: Sequence[np.ndarray],
    title: str,
    path: pathlib.Path,
    names: Sequence[str] | None = None,
) -> pathlib.Path:
    """Write a self-contained interactive orbit viewer (no dependencies)."""
    data = [
        {
            'pts': [round(float(v), 4) for v in np.asarray(c)[:, :3].reshape(-1)],
            'rgb': [round(float(v), 3) for v in col],
            'name': names[i] if names else f'cloud {i}',
        }
        for i, (c, col) in enumerate(zip(clouds, colors))
    ]
    import html as _html

    # escape the title (it lands in <title> and the HUD div) and break any
    # '</script>' that a name could smuggle into the inlined JSON
    payload = json.dumps(data, separators=(',', ':')).replace('</', '<\\/')
    html = _HTML_TEMPLATE.replace(
        '__TITLE__', _html.escape(title or 'Point cloud')
    ).replace('__DATA__', payload)
    path.write_text(html)
    return path


def render_cloud(
    clouds: Sequence[np.ndarray],
    colorscale: str = 'sequence',
    interactive: bool = False,
    arrows: Any = None,
    title: str = '',
    save_dir: str | pathlib.Path | None = None,
    point_radius: float = 0.01,
    size: int = 1024,
) -> pathlib.Path | None:
    """Render one or more point clouds (reference visualization.py:28-97).

    Always rasterizes ``<save_dir>/<title>.png`` (z-buffered sphere splats,
    two-light shading, transparent background) when ``save_dir`` is given;
    with ``interactive=True`` additionally writes ``<title>.html``, a
    self-contained orbit-control viewer (the headless stand-in for the
    reference's interactive pyvista window); without matplotlib it writes
    that viewer and no PNG.  Returns the PNG path (or the HTML path if no
    PNG was written).
    """
    all_clouds = [np.asarray(c) for c in clouds]
    # colors follow the caller's positions (blue = first/original, red =
    # last/recon); dropping an empty cloud must not shift them, and arrows
    # always anchor to the caller's FIRST cloud, never a filtered stand-in
    all_colors = _cloud_colors(len(all_clouds), colorscale)
    arrow_base = all_clouds[0] if all_clouds else None
    keep = [i for i, c in enumerate(all_clouds) if len(c)]
    clouds = [all_clouds[i] for i in keep]
    colors = [all_colors[i] for i in keep]
    if not clouds:
        return None
    radii: list[np.ndarray] = [np.asarray(point_radius) for _ in clouds]
    if arrows is not None:
        arr = np.asarray(arrows)
        if len(arr) != len(arrow_base):
            raise ValueError(
                f'arrows ({len(arr)}) must match the first cloud ({len(arrow_base)})'
            )
        apts, arads = _arrows_to_spheres(arrow_base, arr, point_radius)
        clouds = list(clouds) + [apts]
        colors = colors + [RED]
        radii = radii + [arads]

    out: pathlib.Path | None = None
    html_out: pathlib.Path | None = None
    if save_dir is not None:
        save_dir = pathlib.Path(save_dir)
        save_dir.mkdir(parents=True, exist_ok=True)
        try:
            import matplotlib
        except ImportError:
            logger.warning('render_cloud: matplotlib is not installed; %s gets the HTML viewer, no PNG', title)
            interactive = True
        else:
            rgba = _rasterize(clouds, colors, radii, size=size)
            out = save_dir / f'{_slug(title)}.png'
            matplotlib.use('Agg')
            from matplotlib import pyplot as plt

            plt.imsave(out, np.clip(rgba, 0.0, 1.0))
    if interactive:
        if save_dir is not None:
            html_dir = pathlib.Path(save_dir)
        else:
            # anchor to the active experiment rather than scattering a
            # CWD-relative 'images' dir; fall back to CWD only with no run
            from pccf_torch.experiment import Experiment

            exp = Experiment._current
            html_dir = (exp.exp_dir / 'images') if exp is not None else pathlib.Path('images')
        html_dir.mkdir(parents=True, exist_ok=True)
        html_out = write_html_viewer(
            clouds, colors, title, html_dir / f'{_slug(title)}.html'
        )
    return out or html_out


def plot_confusion_matrix_heatmap(matrix: np.ndarray, class_names: list[str], title: str = '') -> Any:
    """Confusion-matrix heatmap figure (reference visualization.py:100)."""
    import matplotlib

    matplotlib.use('Agg')
    import matplotlib.pyplot as plt

    try:
        import seaborn as sns

        fig, ax = plt.subplots(figsize=(5, 4))
        sns.heatmap(
            matrix, annot=True, fmt='d', cmap='Blues',
            xticklabels=class_names, yticklabels=class_names, ax=ax,
        )
    except ImportError:
        fig, ax = plt.subplots(figsize=(5, 4))
        ax.imshow(matrix, cmap='Blues')
        for i in range(matrix.shape[0]):
            for j in range(matrix.shape[1]):
                ax.text(j, i, str(int(matrix[i, j])), ha='center', va='center')
        ax.set_xticks(range(len(class_names)), class_names)
        ax.set_yticks(range(len(class_names)), class_names)
    ax.set_xlabel('Predicted')
    ax.set_ylabel('True')
    ax.set_title(title)
    fig.tight_layout()
    return fig


def confusion_matrix(predictions: np.ndarray, labels: np.ndarray, n_classes: int) -> np.ndarray:
    """Row = true class, column = prediction."""
    cm = np.zeros((n_classes, n_classes), dtype=np.int64)
    np.add.at(cm, (labels, predictions), 1)
    return cm
