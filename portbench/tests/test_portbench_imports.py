"""Nothing that the harness or the program loads is JAX or the JAX package,
compared by whole top-level names (``pyrecode_tpu_torch`` begins with
``pyrecode_tpu``)."""

import json
import subprocess
import sys

from portbench import spec

SCRIPT = """
import json, sys
import portbench.run as entry
from portbench.tests.small import run_small
run_small("de16_l4_centroid.write")
run_small("de16_l1_zlib.read")
names = sorted({m.split(".", 1)[0] for m in sys.modules})
sys.modules["pyrecode_tpu_torch_extra"] = sys.modules["json"]
clean = entry.loaded_forbidden()
sys.modules["pyrecode_tpu.ops"] = sys.modules["json"]
print(json.dumps({"names": names, "clean": clean, "planted": entry.loaded_forbidden()}))
"""


def test_no_jax_module_is_loaded():
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=spec.REPO, capture_output=True,
                         text=True, timeout=600, env={"PATH": "/usr/bin:/bin",
                                                      "PYTHONPATH": str(spec.REPO)})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert "pyrecode_tpu_torch" in got["names"] and "portbench" in got["names"]
    assert not {"jax", "jaxlib", "flax", "pyrecode_tpu"} & set(got["names"])
    assert got["clean"] == []
    assert got["planted"] == ["pyrecode_tpu"]
