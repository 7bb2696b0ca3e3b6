"""Interactive 3D visualization of Data / NAG objects (reference
src/visualization/visualization.py:19 `visualize_3d`, `figure_html`
:1057, `show` :1077, plotly-based there); counterpart of the JAX
package's `visualization/visualization.py`, whose HTML it reproduces
byte for byte under the same title.

The viewer is a self-contained HTML page with a vanilla-JS canvas orbit
renderer (no plotly or three.js); point positions and colors are
embedded as base64 Float32/Uint8 buffers. numpy alone builds it;
matplotlib is imported by `Figure3D.to_png` only, for a static image.

Coloring per level (rgb, labels, predictions, superpoint partition,
feature PCA, error), voxel and max-point decimation, level centroids and
a shareable standalone HTML file, as in the reference.
"""
import base64
import json
import os

import numpy as np

from ..data.nag import NAG

__all__ = ['visualize_3d', 'Figure3D', 'class_palette']


def class_palette(n, seed=1):
    """n visually-distinct RGB colors in [0,255] (golden-angle hues)."""
    h = (np.arange(n) * 0.61803398875) % 1.0
    s = 0.65 + 0.25 * ((np.arange(n) * 7919) % 3) / 2
    v = 0.85 - 0.25 * ((np.arange(n) * 104729) % 2)
    i = np.floor(h * 6).astype(int)
    f = h * 6 - i
    p, q, t = v * (1 - s), v * (1 - f * s), v * (1 - (1 - f) * s)
    rgb = np.choose(i % 6, [
        np.stack([v, t, p]), np.stack([q, v, p]), np.stack([p, v, t]),
        np.stack([p, q, v]), np.stack([t, p, v]), np.stack([v, p, q])])
    return (rgb.T * 255).astype(np.uint8)


def _decimate(pos, max_points, voxel, rng):
    n = pos.shape[0]
    keep = np.arange(n)
    if voxel is not None and voxel > 0:
        c = np.floor(pos / voxel).astype(np.int64)
        c -= c.min(0)
        dims = c.max(0) + 1
        key = (c[:, 0] * dims[1] + c[:, 1]) * dims[2] + c[:, 2]
        _, keep = np.unique(key, return_index=True)
    if max_points is not None and keep.shape[0] > max_points:
        keep = rng.choice(keep, max_points, replace=False)
    return np.sort(keep)


def _colorize(data, mode, idx, num_classes=None, palette=None):
    n = idx.shape[0]
    if mode == 'rgb' and data.get('rgb') is not None:
        rgb = np.asarray(data.rgb)[idx]
        if rgb.dtype != np.uint8:
            rgb = (np.clip(rgb, 0, 1) * 255).astype(np.uint8)
        return rgb
    if mode in ('y', 'semantic_pred') and data.get(mode) is not None:
        y = np.asarray(data[mode])[idx]
        if y.ndim == 2:
            y = y.argmax(1)
        C = num_classes or int(y.max()) + 1
        pal = palette if palette is not None else class_palette(C + 1)
        return pal[np.clip(y, 0, pal.shape[0] - 1)]
    if mode == 'super_index' and data.get('super_index') is not None:
        si = np.asarray(data.super_index)[idx]
        pal = class_palette(max(int(si.max()) + 1, 1), seed=2)
        return pal[si]
    if mode == 'error' and data.get('y') is not None \
            and data.get('semantic_pred') is not None:
        y = np.asarray(data.y)[idx]
        p = np.asarray(data.semantic_pred)[idx]
        if y.ndim == 2:
            y = y.argmax(1)
        if p.ndim == 2:
            p = p.argmax(1)
        err = (y != p)
        out = np.full((n, 3), 200, np.uint8)
        out[err] = (220, 30, 30)
        return out
    if mode == 'x' and data.get('x') is not None:
        # PCA of features -> RGB (reference feature colorization)
        x = np.asarray(data.x, np.float64)[idx]
        x = x - x.mean(0)
        cov = x.T @ x / max(n - 1, 1)
        w, v = np.linalg.eigh(cov)
        proj = x @ v[:, -3:]
        lo, hi = np.percentile(proj, 2, 0), np.percentile(proj, 98, 0)
        proj = np.clip((proj - lo) / np.maximum(hi - lo, 1e-9), 0, 1)
        return (proj * 255).astype(np.uint8)
    # default: height colormap
    z = np.asarray(data.pos)[idx, 2].astype(np.float64)
    t = (z - z.min()) / max(z.max() - z.min(), 1e-9)
    return np.stack([
        (255 * t), (80 + 100 * (1 - np.abs(t - .5) * 2)),
        (255 * (1 - t))], 1).astype(np.uint8)


_HTML_TEMPLATE = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title>
<style>
 body{margin:0;background:#111;color:#ddd;font-family:sans-serif}
 #hud{position:fixed;top:8px;left:8px;z-index:2;background:#000a;
      padding:6px 10px;border-radius:6px;font-size:13px}
 canvas{display:block}
 select{background:#222;color:#ddd;border:1px solid #555}
</style></head><body>
<div id="hud">__TITLE__ &nbsp;
 <select id="mode" onchange="draw()"></select>
 <span id="info"></span><br>
 <small>drag: orbit &middot; wheel: zoom &middot; shift-drag: pan</small>
</div>
<canvas id="cv"></canvas>
<script>
const LAYERS = __LAYERS__;
function b64f32(s){const b=atob(s),n=b.length;const u=new Uint8Array(n);
 for(let i=0;i<n;i++)u[i]=b.charCodeAt(i);return new Float32Array(u.buffer);}
function b64u8(s){const b=atob(s),n=b.length;const u=new Uint8Array(n);
 for(let i=0;i<n;i++)u[i]=b.charCodeAt(i);return u;}
for(const L of LAYERS){L.pos=b64f32(L.pos);
 for(const k in L.colors)L.colors[k]=b64u8(L.colors[k]);}
const cv=document.getElementById('cv'),ctx=cv.getContext('2d');
let yaw=.6,pitch=.5,dist=2.5,cx=0,cy=0,cz=0,panx=0,pany=0;
(function(){let n=0,mx=[0,0,0];for(const L of LAYERS){const p=L.pos;
 for(let i=0;i<p.length;i+=3){mx[0]+=p[i];mx[1]+=p[i+1];mx[2]+=p[i+2];n++;}}
 cx=mx[0]/n;cy=mx[1]/n;cz=mx[2]/n;let r=0;
 for(const L of LAYERS){const p=L.pos;for(let i=0;i<p.length;i+=3){
  const d=(p[i]-cx)**2+(p[i+1]-cy)**2+(p[i+2]-cz)**2;if(d>r)r=d;}}
 dist=Math.sqrt(r)*2.2;})();
const sel=document.getElementById('mode');
{const ms=new Set();for(const L of LAYERS)for(const k in L.colors)ms.add(k);
 for(const m of ms){const o=document.createElement('option');
  o.value=m;o.textContent=m;sel.appendChild(o);}}
function draw(){
 const W=innerWidth,H=innerHeight;cv.width=W;cv.height=H;
 ctx.fillStyle='#111';ctx.fillRect(0,0,W,H);
 const sy=Math.sin(yaw),cyw=Math.cos(yaw),sp=Math.sin(pitch),
       cp=Math.cos(pitch),f=.9*Math.min(W,H),mode=sel.value;
 const img=ctx.createImageData(W,H);const zbuf=new Float32Array(W*H);
 zbuf.fill(1e30);const id=img.data;
 for(const L of LAYERS){const p=L.pos,
  col=L.colors[mode]||L.colors[Object.keys(L.colors)[0]],sz=L.size|0;
  for(let i=0,j=0;i<p.length;i+=3,j+=3){
   let x=p[i]-cx,y=p[i+1]-cy,z=p[i+2]-cz;
   let x1=cyw*x+sy*y,y1=-sy*x+cyw*y;
   let y2=cp*y1+sp*z,z2=-sp*y1+cp*z;
   z2+=dist;if(z2<=.05)continue;
   const px=(x1*f/z2+W/2+panx)|0,py=(-y2*f/z2+H/2+pany)|0;
   for(let dx=0;dx<=sz;dx++)for(let dy=0;dy<=sz;dy++){
    const qx=px+dx,qy=py+dy;
    if(qx<0||qx>=W||qy<0||qy>=H)continue;const o=qy*W+qx;
    if(z2<zbuf[o]){zbuf[o]=z2;const o4=o*4;
     id[o4]=col[j];id[o4+1]=col[j+1];id[o4+2]=col[j+2];id[o4+3]=255;}}}}
 ctx.putImageData(img,0,0);
 document.getElementById('info').textContent=
  LAYERS.map(L=>L.name+':'+(L.pos.length/3)).join(' ');
}
let drag=false,px0=0,py0=0,shift=false;
cv.onmousedown=e=>{drag=true;px0=e.clientX;py0=e.clientY;shift=e.shiftKey};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-px0,dy=e.clientY-py0;px0=e.clientX;py0=e.clientY;
 if(shift){panx+=dx;pany+=dy}else{yaw+=dx*.008;pitch+=dy*.008;}
 requestAnimationFrame(draw);};
cv.onwheel=e=>{dist*=Math.exp(e.deltaY*.001);requestAnimationFrame(draw);
 e.preventDefault();};
window.onresize=draw;draw();
</script></body></html>"""


class Figure3D:
    """Composed multi-layer 3D figure with HTML / PNG export."""

    def __init__(self, title='superpoint_transformer_torch'):
        self.title = title
        self.layers = []

    def add_layer(self, name, pos, colors, point_size=1):
        """colors: dict mode -> [N, 3] uint8."""
        self.layers.append(dict(
            name=name, pos=np.asarray(pos, np.float32),
            colors={k: np.asarray(v, np.uint8) for k, v in colors.items()},
            size=int(point_size)))
        return self

    def html(self):
        layers = []
        for L in self.layers:
            layers.append(dict(
                name=L['name'],
                pos=base64.b64encode(
                    L['pos'].astype('<f4').tobytes()).decode(),
                colors={k: base64.b64encode(v.tobytes()).decode()
                        for k, v in L['colors'].items()},
                size=L['size']))
        return (_HTML_TEMPLATE
                .replace('__TITLE__', self.title)
                .replace('__LAYERS__', json.dumps(layers)))

    def write_html(self, path):
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, 'w') as f:
            f.write(self.html())
        return path

    def to_png(self, path, mode=None, figsize=(10, 10), dpi=100):
        """Static matplotlib render (first layer, chosen color mode)."""
        import matplotlib
        matplotlib.use('Agg')
        import matplotlib.pyplot as plt
        fig = plt.figure(figsize=figsize)
        ax = fig.add_subplot(projection='3d')
        for L in self.layers:
            colors = L['colors']
            key = mode if mode in colors else next(iter(colors))
            ax.scatter(*L['pos'].T, c=colors[key] / 255.0,
                       s=0.5 + L['size'], linewidths=0)
        ax.set_axis_off()
        fig.savefig(path, dpi=dpi, bbox_inches='tight')
        plt.close(fig)
        return path

    def show(self, path=None):
        """Write the shareable HTML (reference `show` exports HTML when
        no notebook frontend is attached)."""
        return self.write_html(path or 'figure_3d.html')


def visualize_3d(obj, keys=('rgb', 'y', 'semantic_pred', 'super_index',
                            'error', 'x'),
                 max_points=100_000, voxel=None, levels=None,
                 num_classes=None, centroids=True, title=None, seed=0):
    """Build a Figure3D from a Data or NAG (reference visualize_3d,
    src/visualization/visualization.py:19).

    :param obj: Data or NAG
    :param keys: color modes to embed (missing attributes are skipped)
    :param max_points: per-level decimation cap
    :param voxel: optional decimation voxel size
    :param levels: NAG levels to draw (default: level 0 + centroids)
    """
    rng = np.random.default_rng(seed)
    fig = Figure3D(title=title or 'superpoint_transformer_torch')

    def add_data(name, d, point_size=1):
        pos = np.asarray(d.pos)
        idx = _decimate(pos, max_points, voxel, rng)
        colors = {}
        for mode in keys:
            try:
                c = _colorize(d, mode, idx, num_classes=num_classes)
            except (AttributeError, IndexError, KeyError, TypeError,
                    ValueError, np.linalg.LinAlgError):
                c = None   # a mode this data cannot color is left out
            if c is not None and (mode in ('height',)
                                  or d.get(mode) is not None
                                  or mode == 'error'):
                colors[mode] = c
        if not colors:
            colors['height'] = _colorize(d, 'height', idx)
        fig.add_layer(name, pos[idx], colors, point_size=point_size)

    if isinstance(obj, NAG):
        lvls = levels if levels is not None else [obj.start_i_level]
        for i in lvls:
            add_data(f'P{i}', obj[i])
        if centroids:
            for i in obj.levels[1:]:
                d = obj[i]
                if d.get('pos') is not None:
                    add_data(f'P{i}-centroids', d, point_size=2)
    else:
        add_data('points', obj)
    return fig
