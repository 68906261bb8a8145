# coding: utf-8
"""Offline preprocessing: k-core pyramids and random-walk tables, written
in the artifact layout ``ctgcn_tpu`` reads and writes."""
import time

from ctgcn_torch.preprocessing.kcore import StructureInfoGenerator
from ctgcn_torch.preprocessing.walks import WalkGenerator


def preprocess(method, args):
    """Entry point of the ``preprocessing`` task for one method's config.

    Config keys as in ``ctgcn_tpu``; ``worker`` is ignored (snapshots run
    one after another) and ``seed`` (default 0) seeds the walk sampler."""
    del method
    base_path = args["base_path"]
    origin_folder = args["origin_folder"]
    core_folder = args.get("core_folder", None)
    node_file = args["node_file"]
    file_sep = args.get("file_sep", "\t")
    if core_folder is not None and args.get("generate_core", True):
        t0 = time.time()
        StructureInfoGenerator(base_path, origin_folder, core_folder,
                               node_file).get_kcore_graph_all_time(sep=file_sep)
        print("core generation cost:", time.time() - t0, "seconds")
    if args.get("run_walk", True):
        t0 = time.time()
        WalkGenerator(base_path, origin_folder, args["walk_pair_folder"],
                      args["node_freq_folder"], node_file,
                      walk_time=args.get("walk_time", 100),
                      walk_length=args.get("walk_length", 5),
                      weighted=args.get("weighted", True),
                      seed=args.get("seed", 0)).get_walk_info_all_time(
                          sep=file_sep)
        print("walk generation cost:", time.time() - t0, "seconds")
