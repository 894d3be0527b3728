"""The v1 trainer's data readers in showo_tpu_torch against the JAX
package's, on tiny data made in a temporary directory from the in-tree
images (``assets/validation``) and seeded arrays.

* ``brace_expand`` and ``remove_prefix``;
* a tar shard's samples: the port's native reader (``csrc/host/tario.cpp``
  built with g++) and its ``tarfile`` fallback give JAX's samples byte for
  byte, GNU long names and a corrupt shard included; each says which path
  ran (``native_tar.paths``);
* ``decode_batch`` (``csrc/host/imgdec.cpp``, PIL for what it cannot
  decode) equal to JAX's, and the PIL path alone when the library is
  missing (``native_image.paths``);
* ``Text2ImageTarDataset`` samples (shuffled, resampled, per-process
  shards), ``ExternalCaptionJoin`` and ``ImageNetDataset`` equal to
  JAX's for one seed;
* ``RefinedWebDataset`` rows and crops equal to JAX's for one seed and
  rank;
* ``_build_loaders`` of the stage-1 config over such data, and its
  loaders' states round-tripping: a restored loader goes on where the
  saved one stopped.
"""

import io
import json
import os
import tarfile

import numpy as np
import pytest
import torch

from showo_tpu.data import imagenet as jimagenet
from showo_tpu.data import native_image as jimg
from showo_tpu.data import native_tar as jtar
from showo_tpu.data import refinedweb as jrw
from showo_tpu.data import tar_shards as jshards
from showo_tpu_torch.data import imagenet as timagenet
from showo_tpu_torch.data import native_image as timg
from showo_tpu_torch.data import native_tar as ttar
from showo_tpu_torch.data import refinedweb as trw
from showo_tpu_torch.data import tar_shards as tshards

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ASSETS = os.path.join(REPO, "assets", "validation")


def _image_bytes(i, fmt="JPEG", size=(40, 32)):
    """An in-tree image, cropped and tinted by ``i``, encoded as ``fmt``."""
    from PIL import Image

    src = Image.open(os.path.join(ASSETS, "test_image.png")).convert("RGB")
    img = src.crop((8 * i, 4 * i, 8 * i + 96, 4 * i + 80)).resize(size)
    img = Image.blend(img, Image.new("RGB", size, (30 * i % 255, 90, 160)),
                      0.3)
    buf = io.BytesIO()
    img.save(buf, format=fmt, quality=92)
    return buf.getvalue()


def write_shard(path, start, n, long_name=False):
    """A webdataset-style shard: ``n`` samples of a .jpg (a .png every
    third) and a .txt, keys from ``start``."""
    with tarfile.open(path, "w") as tf:
        for i in range(start, start + n):
            key = f"{i:05d}"
            ext, fmt = ("png", "PNG") if i % 3 == 2 else ("jpg", "JPEG")
            members = [(f"{key}.{ext}", _image_bytes(i % 7, fmt)),
                       (f"{key}.txt",
                        f"The image features sample {i}. More.".encode())]
            if long_name and i == start:
                members.append(("deeply/nested/" + "x" * 150 + ".bin",
                                b"long-name payload"))
            for name, data in members:
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))


@pytest.fixture()
def shards(tmp_path):
    for s in range(2):
        write_shard(tmp_path / f"shard-{s:05d}.tar", 10 * s, 4,
                    long_name=s == 0)
    return str(tmp_path / "shard-{00000..00001}.tar")


def test_brace_expand_and_prefixes_vs_jax():
    for pat in ("s-{000..002}.tar", "a{0..1}/b{08..10}.tar", "plain.tar"):
        assert tshards.brace_expand(pat) == jshards.brace_expand(pat)
    assert tshards.brace_expand("x{8..10}")[-1] == "x10"
    for cap in ("The image features a cat. This is it.", "plain"):
        assert tshards.remove_prefix(cap) == jshards.remove_prefix(cap)
    assert tshards.REMOVE_PREFIXES == jshards.REMOVE_PREFIXES
    assert tshards.CAPTION_PROMPTS == jshards.CAPTION_PROMPTS


def _same_samples(got, want):
    got, want = list(got), list(want)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k] == w[k], k


def test_tar_samples_native_and_tarfile_vs_jax(shards, tmp_path):
    path = tshards.brace_expand(shards)[0]
    want = list(jshards.iterate_tar_samples(path))
    assert len(want) == 5          # four samples and the long name's group
    before = dict(ttar.paths)
    _same_samples(tshards.iterate_tar_samples_native(path), want)
    _same_samples(jshards.iterate_tar_samples_native(path), want)
    assert ttar.paths["native"] == before.get("native", 0) + 1
    _same_samples(tshards.iterate_tar_samples(path), want)
    # the fallback: no library, tarfile's index and plain reads
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttar, "_lib", False)
        idx = ttar.TarIndex(path)
        assert not idx.native
        _same_samples(tshards.iterate_tar_samples_native(path), want)
    assert ttar.paths["tarfile"] >= 2
    native = ttar.TarIndex(path)
    assert native.native and native.names == jtar.TarIndex(path).names
    order = [3, 0, 7]
    assert native.read(order, num_threads=3) == idx.read(order)
    # a corrupt shard is skipped, as JAX's
    bad = tmp_path / "bad.tar"
    bad.write_bytes(b"\x00garbage" * 100)
    assert list(tshards.iterate_tar_samples(str(bad))) == \
        list(jshards.iterate_tar_samples(str(bad))) == []


def test_decode_batch_vs_jax():
    bufs = [_image_bytes(0), _image_bytes(1, "PNG"), b"not an image",
            _image_bytes(2, size=(64, 48))]
    want, wvalid = jimg.decode_batch(bufs, resolution=16)
    before = dict(timg.paths)
    got, valid = timg.decode_batch(bufs, resolution=16, num_threads=3)
    assert valid == wvalid == [True, True, False, True]
    np.testing.assert_array_equal(got, want)
    assert timg.paths["native"] - before.get("native", 0) == 2
    assert timg.paths["pil"] - before.get("pil", 0) == 1
    # without the library every image goes through PIL, as JAX's fallback
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(timg, "_lib", False)
        mp.setattr(jimg, "_lib", False)
        got, valid = timg.decode_batch(bufs, resolution=16)
        want, wvalid = jimg.decode_batch(bufs, resolution=16)
    assert valid == wvalid
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("native", [True, False])
@pytest.mark.parametrize("shuffle,resample", [(0, False), (4, True)])
def test_tar_dataset_vs_jax(shards, native, shuffle, resample):
    kw = dict(resolution=16, shuffle_buffer=shuffle, resample=resample,
              seed=3, use_native=native)

    def take(mod, n=10):
        ds = mod.Text2ImageTarDataset(shards, **kw)
        it = iter(ds)
        return [next(it) for _ in range(n if resample else 8)]

    got, want = take(tshards), take(jshards)
    for g, w in zip(got, want):
        assert g["text"] == w["text"]
        np.testing.assert_array_equal(g["image"], w["image"])
    assert got[0]["text"].startswith("sample")     # the prefix is gone


def test_tar_dataset_shards_per_process(shards):
    from showo_tpu_torch.data import loader as tloader

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tloader, "process_rank", lambda: (1, 2))
        ds = tshards.Text2ImageTarDataset(shards, resolution=16)
    assert ds.shards == [tshards.brace_expand(shards)[1]]


def test_external_caption_join_vs_jax(tmp_path):
    sa1b = tmp_path / "sa1b"
    sa1b.mkdir()
    (sa1b / "sa_001.txt").write_text(
        "The image features a red fox. It sits on grass.\n")
    laion = tmp_path / "laion" / "00005"
    laion.mkdir(parents=True)
    (laion / "k1.caption").write_text("A blue bird. Close up.\n")
    jdb = tmp_path / "jdb.json"
    jdb.write_text(json.dumps({"jdb_key": ["one", "two", "three"]}))
    calls = [({"txt": b""}, "x/SA1B/s.tar", "SA1B/sa_001"),
             ({}, "/d/laion/00005.tar", "k1"), ({}, "any", "jdb_key"),
             ({"txt": b"fallback"}, "other", "k")] * 6
    for captioning in (False, True):
        kw = dict(sa1b_caption_dir=str(sa1b),
                  laion_caption_dir=str(tmp_path / "laion"),
                  journeydb_caption_json=str(jdb), is_captioning=captioning,
                  add_caption_prompt=captioning, seed=4)
        tj, jj = (tshards.ExternalCaptionJoin(**kw),
                  jshards.ExternalCaptionJoin(**kw))
        assert [tj(*c) for c in calls] == [jj(*c) for c in calls]


def write_imagenet(root, classes=("n01_tench", "n02_goldfish"), per=3):
    for c, cls in enumerate(classes):
        d = os.path.join(root, cls)
        os.makedirs(d, exist_ok=True)
        for i in range(per):
            with open(os.path.join(d, f"{i}.jpg"), "wb") as f:
                f.write(_image_bytes(c * per + i))
    with open(os.path.join(root, "not_a_class.txt"), "w") as f:
        f.write("skipped")


def test_imagenet_dataset_vs_jax(tmp_path):
    root = str(tmp_path / "train")
    write_imagenet(root)
    mapping = tmp_path / "labels.txt"
    mapping.write_text("n01_tench tench, Tinca tinca\nbroken-line\n")
    with open(os.path.join(root, "n02_goldfish", "9.jpg"), "wb") as f:
        f.write(b"corrupt")                    # passes to the next index
    for path in (None, str(mapping)):
        td = timagenet.ImageNetDataset(root, 16, path, seed=2)
        jd = jimagenet.ImageNetDataset(root, 16, path, seed=2)
        assert td.samples == jd.samples and len(td) == 7
        got, want = list(td), list(jd)
        for g, w in zip(got, want):
            assert g["text"] == w["text"]
            np.testing.assert_array_equal(g["image"], w["image"])
    assert {g["text"] for g in got} == {"tench, Tinca tinca", "n02 goldfish"}
    assert timagenet.load_label_mapping(str(mapping)) == \
        jimagenet.load_label_mapping(str(mapping))


def write_parquet(path, n=12, seed=0):
    import pyarrow as pa
    import pyarrow.parquet as pq

    rng = np.random.default_rng(seed)
    rows = [" ".join(f"w{int(x)}" for x in rng.integers(0, 99, 20 + 7 * i))
            + "\nnext line" for i in range(n)]
    rows[3] = ""                                 # an empty row is skipped
    pq.write_table(pa.table({"content": rows}), path, row_group_size=5)


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_refinedweb_vs_jax(tmp_path, rank, world):
    for i in range(2):
        write_parquet(str(tmp_path / f"d{i}.parquet"), seed=i)
    pattern = str(tmp_path / "d*.parquet")
    kw = dict(rank=rank, world_size=world, max_length=60, seed=5)
    got = list(trw.RefinedWebDataset(pattern, **kw))
    want = list(jrw.RefinedWebDataset(pattern, **kw))
    assert got == want and len(got) > 2
    assert all(len(s["input_ids"]) <= 60 and "\n" not in s["input_ids"]
               for s in got)
    with pytest.raises(FileNotFoundError):
        trw.RefinedWebDataset(str(tmp_path / "none*.parquet"))


def test_build_loaders_and_their_states(tmp_path):
    """The stage-1 config's three loaders over an ImageNet folder, tar
    shards and parquet; each loader's state saved after two batches and
    restored into new loaders, which go on with the third."""
    from showo_tpu_torch.config import load_config
    from showo_tpu_torch.data.loader import (restore_loader_state,
                                             save_loader_state)
    from showo_tpu_torch.training.train_showo import _build_loaders

    write_imagenet(str(tmp_path / "imagenet"))
    write_shard(tmp_path / "cap-00000.tar", 0, 5)
    write_parquet(str(tmp_path / "lm.parquet"))
    config = load_config(os.path.join(REPO, "configs",
                                      "showo_pretraining_stage1.yaml"), [
        f"dataset.params.train_t2i_shards_path_or_url={tmp_path}/imagenet",
        "dataset.params.train_mmu_shards_path_or_url="
        f"{tmp_path}/cap-{{00000..00000}}.tar",
        f"dataset.params.train_lm_shards_path_or_url={tmp_path}/lm.parquet",
        "dataset.params.resolution=16", "dataset.params.shuffle_buffer_size=3",
        "training.batch_size_t2i=2", "training.batch_size_lm=3",
        "training.batch_size_mmu=2"])
    loaders = _build_loaders(config)
    its = [iter(ld) for ld in loaders]
    for it in its:
        next(it), next(it)
    for name, ld in zip(("t2i", "lm", "mmu"), loaders):
        save_loader_state(ld, str(tmp_path / "out"), 2, name=name)
    third = [next(it) for it in its]
    assert third[0]["image"].shape == (2, 16, 16, 3)
    assert len(third[1]["input_ids"]) == 3
    fresh = _build_loaders(config)
    for name, ld in zip(("t2i", "lm", "mmu"), fresh):
        assert restore_loader_state(ld, str(tmp_path / "out"), 2, name=name)
    for old, new in zip(third, [next(iter(ld)) for ld in fresh]):
        assert set(old) == set(new)
        for k in old:
            np.testing.assert_array_equal(np.asarray(new[k]),
                                          np.asarray(old[k]), err_msg=k)
    assert [ld.batches_yielded for ld in fresh] == [3, 3, 3]
