"""The port's `tools/create_data.py` against `tools_tpu/create_data.py`,
under the miniature devkit stand-ins of tests/test_create_data.py
(pyquaternion, nuscenes' Box and LidarPointCloud, a two-annotation,
one-lidar scene), with a stand-in `NuScenes` and `splits` added for
`main`: both tools give the same info dicts (pickle bytes), the same
point-label files (bytes) and, through `main`, the same info pickles
(bytes) for the train and the val split.
"""
import pickle
import sys
import types
from pathlib import Path

from test_create_data import _fixture, _install_fake_devkit

from ocrfdet_tpu_torch.tools import create_data as tcreate
from tools_tpu import create_data as jcreate


def test_sample_info_is_the_same_pickle(tmp_path, monkeypatch):
    _install_fake_devkit(monkeypatch)
    nusc, sample, _ = _fixture(tmp_path)
    want = pickle.dumps(jcreate.sample_info(nusc, sample))
    got = pickle.dumps(tcreate.sample_info(nusc, sample))
    assert got == want
    assert tcreate.CAMS == jcreate.CAMS
    assert tcreate.NAME_MAP == jcreate.NAME_MAP


def _label_files(root: Path):
    return {p.relative_to(root): p.read_bytes()
            for p in sorted((root / "samples_point_label").rglob("*.npy"))}


def test_point_labels_are_the_same_files(tmp_path, monkeypatch):
    _install_fake_devkit(monkeypatch)
    nusc, sample, _ = _fixture(tmp_path)
    jcreate.generate_point_labels(nusc, sample, str(tmp_path))
    want = _label_files(tmp_path)
    for p in want:
        (tmp_path / p).unlink()
    tcreate.generate_point_labels(nusc, sample, str(tmp_path))
    got = _label_files(tmp_path)
    assert len(want) == 6 and got == want


def test_main_writes_the_same_info_pickles(tmp_path, monkeypatch):
    _install_fake_devkit(monkeypatch)
    nusc, sample, _ = _fixture(tmp_path)
    # a second sample of another scene, which goes to the val split
    sample2 = dict(sample, token="tok1", scene_token="scene1",
                   anns=["ann1"])
    nusc.sample = [sample, sample2]
    nusc.scene = [dict(token="scene0", name="scene-0001"),
                  dict(token="scene1", name="scene-0003")]
    mod = types.ModuleType("nuscenes.nuscenes")
    mod.NuScenes = lambda version, dataroot, verbose: nusc
    splits = types.ModuleType("nuscenes.utils.splits")
    splits.train, splits.val = ["scene-0001"], ["scene-0003"]
    splits.mini_train, splits.mini_val = [], []
    sys.modules["nuscenes"].nuscenes = mod
    sys.modules["nuscenes.utils"].splits = splits
    monkeypatch.setitem(sys.modules, "nuscenes.nuscenes", mod)
    monkeypatch.setitem(sys.modules, "nuscenes.utils.splits", splits)

    argv = ["--root", str(tmp_path), "--version", "v1.0-trainval",
            "--point-labels"]
    names = [f"bevdetv2-nuscenes_infos_{s}.pkl" for s in ("train", "val")]
    monkeypatch.setattr(sys, "argv", ["create_data.py"] + argv)
    jcreate.main()
    want = {n: (tmp_path / n).read_bytes() for n in names}
    want_labels = _label_files(tmp_path)
    for n in names:
        (tmp_path / n).unlink()
    tcreate.main(argv)
    assert {n: (tmp_path / n).read_bytes() for n in names} == want
    assert _label_files(tmp_path) == want_labels
    infos = pickle.loads(want[names[0]])["infos"]
    assert [i["token"] for i in infos] == ["tok0"]
    assert [i["token"] for i in pickle.loads(want[names[1]])["infos"]] \
        == ["tok1"]
