"""Reader for the reference's XML configuration files.

Lets a user of the reference point this engine at their existing
``resources/`` directory and get the identical operating point
(reference: resources/putslamconfigGlobal.xml → component parameter files,
parsed by tinyXML2 in PUTSLAM.cpp:454-576 and the nested Config ctors;
camera/dataset chain putslamfileModel.xml → datasetConfig/<seq>.xml).

Only parameters with a counterpart in this engine are mapped; everything
else keeps the dataclass defaults (documented in config.py).
"""

from __future__ import annotations

import dataclasses
import os
import xml.etree.ElementTree as ET
from typing import Optional

from putslam_tpu.config import (CameraConfig, DetectorConfig, MapConfig,
                                MatcherConfig, RansacConfig, SlamConfig,
                                TrackerConfig)


def _parse_lenient(path: str) -> ET.Element:
    """tinyXML2 accepts multiple top-level elements (the reference's
    datasetConfig files have <Model/> followed by <datasetPath/>); wrap the
    document in a synthetic root so ElementTree accepts it too."""
    with open(path) as f:
        text = f.read()
    # strip the xml declaration if present, then wrap
    if text.lstrip().startswith("<?"):
        text = text[text.index("?>") + 2:]
    # the reference repo ships files with unresolved git conflict markers
    # (e.g. putslamfileModel.xml): keep the HEAD side, drop the other
    if "<<<<<<<" in text:
        lines, keep, out = text.splitlines(), True, []
        for ln in lines:
            if ln.startswith("<<<<<<<"):
                keep = True
                continue
            if ln.startswith("======="):
                keep = False
                continue
            if ln.startswith(">>>>>>>"):
                keep = True
                continue
            if keep:
                out.append(ln)
        text = "\n".join(out)
    return ET.fromstring("<__root__>" + text + "</__root__>")


def _attr(el, name, cast, default):
    if el is None:
        return default
    v = el.get(name)
    if v is None:
        return default
    if cast is bool:
        return v.strip().lower() in ("1", "true", "yes")
    return cast(v)


def load_camera_config(model_xml: str, base: Optional[CameraConfig] = None
                       ) -> CameraConfig:
    """datasetConfig/<seq>.xml → CameraConfig (intrinsics, distortion,
    variance models, depth scale)."""
    base = base or CameraConfig()
    doc = _parse_lenient(model_xml)
    root = doc.find("Model") if doc.find("Model") is not None else doc
    f = root.find("focalLength")
    c = root.find("focalAxis")
    d = root.find("rgbDistortion")
    s = root.find("imageSize")
    var = root.find("variance")
    vd = root.find("varianceDepth")
    kw = dict(
        fu=_attr(f, "fu", float, base.fu),
        fv=_attr(f, "fv", float, base.fv),
        cu=_attr(c, "Cu", float, base.cu),
        cv=_attr(c, "Cv", float, base.cv),
        k1=_attr(d, "k1", float, base.k1),
        k2=_attr(d, "k2", float, base.k2),
        p1=_attr(d, "p1", float, base.p1),
        p2=_attr(d, "p2", float, base.p2),
        k3=_attr(d, "k3", float, base.k3),
        width=_attr(s, "sizeU", int, base.width),
        height=_attr(s, "sizeV", int, base.height),
        sigma_u=_attr(var, "sigmaU", float, base.sigma_u),
        sigma_v=_attr(var, "sigmaV", float, base.sigma_v),
        var_c3=_attr(vd, "c3", float, base.var_c3),
        var_c2=_attr(vd, "c2", float, base.var_c2),
        var_c1=_attr(vd, "c1", float, base.var_c1),
        var_c0=_attr(vd, "c0", float, base.var_c0),
    )
    # datasetPath (a sibling top-level element) carries depthImageScale
    for el in doc.iter():
        if el.tag == "datasetPath":
            kw["depth_image_scale"] = _attr(el, "depthImageScale", float,
                                            base.depth_image_scale)
    return dataclasses.replace(base, **kw)


def load_matcher_config(matcher_xml: str, cfg: SlamConfig) -> SlamConfig:
    """putslammatcherOpenCVParameters.xml → RANSAC/Matcher/Tracker params."""
    root = ET.parse(matcher_xml).getroot()
    vo_version = _attr(root, "VOVersion", int, cfg.vo_version)
    r = root.find("RANSAC")
    ransac = dataclasses.replace(
        cfg.ransac,
        error_version=_attr(r, "errorVersionVO", int, cfg.ransac.error_version),
        inlier_threshold_euclidean=_attr(
            r, "inlierThresholdEuclidean", float,
            cfg.ransac.inlier_threshold_euclidean),
        inlier_threshold_reprojection=_attr(
            r, "inlierThresholdReprojection", float,
            cfg.ransac.inlier_threshold_reprojection),
        inlier_threshold_mahalanobis=_attr(
            r, "inlierThresholdMahalanobis", float,
            cfg.ransac.inlier_threshold_mahalanobis),
        minimal_inlier_ratio=_attr(
            r, "minimalInlierRatioThreshold", float,
            cfg.ransac.minimal_inlier_ratio),
        minimal_num_matches=_attr(
            r, "minimalNumberOfMatches", int, cfg.ransac.minimal_num_matches),
        used_pairs=_attr(r, "usedPairs", int, cfg.ransac.used_pairs),
    )
    # the detector/matcher/tracker knobs live on ONE <MatcherOpenCV .../>
    # element in the reference XML (matcher.h:177-369 parses the same)
    m = root.find("MatcherOpenCV")
    matcher = cfg.matcher
    detector = cfg.detector
    tracker = cfg.tracker
    if m is not None:
        desc_name = (m.get("descriptor") or "ORB").upper()
        detector = dataclasses.replace(
            detector,
            grid_rows=_attr(m, "gridRows", int, detector.grid_rows),
            grid_cols=_attr(m, "gridCols", int, detector.grid_cols),
            nms_radius=max(int(_attr(m, "DBScanEps", float,
                                     float(detector.nms_radius))), 1),
            # binary families map onto the steered-BRIEF/LDB banks; float
            # SURF/SIFT are out of scope (BASELINE.md operating point)
            descriptor="ldb" if desc_name == "LDB" else detector.descriptor,
        )
        matcher = dataclasses.replace(
            matcher,
            matching_xyz_sphere_radius=_attr(
                m, "matchingXYZSphereRadius", float,
                matcher.matching_xyz_sphere_radius),
            matching_xyz_acceptance_ratio=_attr(
                m, "matchingXYZacceptRatioOfBestMatch", float,
                matcher.matching_xyz_acceptance_ratio),
        )
        tracker = dataclasses.replace(
            tracker,
            win_size=_attr(m, "winSize", int, tracker.win_size),
            max_levels=_attr(m, "maxLevels", int, tracker.max_levels),
            max_iter=_attr(m, "maxIter", int, tracker.max_iter),
            eps=_attr(m, "eps", float, tracker.eps),
            error_threshold=_attr(m, "trackingErrorThreshold", float,
                                  tracker.error_threshold),
            min_tracked_features=_attr(m, "minimalTrackedFeatures", int,
                                       tracker.min_tracked_features),
        )
    p = root.find("MatchingOnPatches")
    if p is not None:
        tracker = dataclasses.replace(
            tracker,
            patch_refine=bool(_attr(p, "warping", int, 0)),
            patch_refine_win=_attr(p, "patchSize", int,
                                   tracker.patch_refine_win),
        )
    return cfg.replace(ransac=ransac, matcher=matcher, detector=detector,
                       tracker=tracker, vo_version=vo_version)


def load_map_config(map_xml: str, cfg: SlamConfig) -> SlamConfig:
    """putslammapConfig.xml → MapConfig."""
    root = ET.parse(map_xml).getroot()
    p = root.find("parameters")
    comp = root.find("mapCompression")
    mp = dataclasses.replace(
        cfg.map,
        use_uncertainty=_attr(p, "useUncertainty", bool,
                              cfg.map.use_uncertainty),
        add_pose_to_pose_edges=_attr(p, "addPoseToPoseEdges", bool,
                                     cfg.map.add_pose_to_pose_edges),
        max_measurements_pose_to_pose=_attr(
            p, "maxMeasurementsToAddPoseToPoseEdge", int,
            cfg.map.max_measurements_pose_to_pose),
        min_measurements_pose_to_feature=_attr(
            p, "minMeasurementsToAddPoseToFeatureEdge", int,
            cfg.map.min_measurements_pose_to_feature),
        add_features_when_map_size_less_than=_attr(
            p, "addFeaturesWhenMapSizeLessThan", int,
            cfg.map.add_features_when_map_size_less_than),
        add_features_when_measurements_less_than=_attr(
            p, "addFeaturesWhenMeasurementSizeLessThan", int,
            cfg.map.add_features_when_measurements_less_than),
        max_once_feature_add=_attr(p, "maxOnceFeatureAdd", int,
                                   cfg.map.max_once_feature_add),
        min_euclidean_distance_of_features=_attr(
            p, "minEuclideanDistanceOfFeatures", float,
            cfg.map.min_euclidean_distance_of_features),
        min_image_distance_of_features=_attr(
            p, "minImageDistanceOfFeatures", float,
            cfg.map.min_image_distance_of_features),
        add_no_features_when_map_size_greater_than=_attr(
            p, "addNoFeaturesWhenMapSizeGreaterThan", int,
            cfg.map.add_no_features_when_map_size_greater_than),
        covisibility_keyframe=_attr(comp, "covisibilityKeyframes", float,
                                    cfg.map.covisibility_keyframe),
        marginalization_thr=_attr(comp, "marginalizationThr", float,
                                  cfg.map.marginalization_thr),
        min_frames_between_keyframes=_attr(comp, "minFramesNo", int,
                                           cfg.map.min_frames_between_keyframes),
        max_frames_window=_attr(comp, "maxFramesNo", int,
                                cfg.map.max_frames_window),
        # uncertaintyModel: 0 sensor J·R·Jᵀ, 1 normal-scaled, 2 gradient-
        # scaled (featuresMap.cpp:112-120 dispatch)
        uncertainty_model={0: "sensor", 1: "normal", 2: "gradient"}.get(
            _attr(p, "uncertaintyModel", int, 0), cfg.map.uncertainty_model),
    )
    # optimizationErrorType: 0 → Edge3D euclidean, 1 → reprojection
    # (featuresMap config drives which edge the graph gets)
    backend = dataclasses.replace(
        cfg.backend,
        error_type=_attr(p, "optimizationErrorType", int,
                         cfg.backend.error_type),
    )
    return cfg.replace(map=mp, backend=backend)


def load_reference_config(resources_dir: str,
                          dataset_config: Optional[str] = None) -> SlamConfig:
    """Full chain: resources/ directory (reference layout) → SlamConfig.

    ``dataset_config``: name of a datasetConfig/<name>.xml to use for the
    camera (default: the one referenced by putslamfileModel.xml if present).
    """
    cfg = SlamConfig()
    # global thread/mode switches (putslamconfigGlobal.xml,
    # PUTSLAM.cpp:454-486): onlyVO and the loop-closure thread toggle
    global_xml = os.path.join(resources_dir, "putslamconfigGlobal.xml")
    if os.path.exists(global_xml):
        groot = _parse_lenient(global_xml)
        ps = groot.find("PUTSLAM")
        th = groot.find("ThreadSettings")
        cfg = cfg.replace(
            only_vo=bool(_attr(ps, "onlyVO", int, 0)),
            loop_closure=dataclasses.replace(
                cfg.loop_closure,
                enabled=bool(_attr(th, "loopClosureThreadVersion", int, 0))))
    matcher_xml = os.path.join(resources_dir,
                               "putslammatcherOpenCVParameters.xml")
    if os.path.exists(matcher_xml):
        cfg = load_matcher_config(matcher_xml, cfg)
    map_xml = os.path.join(resources_dir, "putslammapConfig.xml")
    if os.path.exists(map_xml):
        cfg = load_map_config(map_xml, cfg)

    cam_xml = None
    if dataset_config:
        cam_xml = os.path.join(resources_dir, "datasetConfig",
                               dataset_config if dataset_config.endswith(".xml")
                               else dataset_config + ".xml")
    else:
        model = os.path.join(resources_dir, "putslamfileModel.xml")
        if os.path.exists(model):
            root = _parse_lenient(model)
            for el in root.iter():
                rel = el.get("datasetFile") if el.tag == "Model" else None
                if rel:
                    cam_xml = os.path.join(resources_dir, rel)
                    break
    if cam_xml and os.path.exists(cam_xml):
        cfg = cfg.replace(camera=load_camera_config(cam_xml))
    return cfg
